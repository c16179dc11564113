// Fused QHNet tensor-product kernels for Hopper (sm_90a).
//
// Per molecule b, receiver i and sender j, the gate MLPs' second Dense gives
// the path weights of the 65 tensor-product paths (l1, l2, l3) at LMAX 4:
//   u_r = h_r[b,i,j] @ W2r + b2r     u_s = h_s[b,i,j] @ W2s + b2s     w = u_r * u_s   [P*C]
//   conv: agg[b,i,l3^2+m,c] = sum_j sum_p sum_a cgsh[b,i,j,off_p+a*(2l3+1)+m] x[b,l1^2+a,j,c] w[pC+c]
//   pair: fij[b,i,l3^2+m,j,c] = sum_p w[pC+c] maskf[b,i,j] sum_b zi[b,i,off_p+b*(2l3+1)+m,c] x[b,l2^2+b,j,c]
//
// Kernel I replaces nabladft_tpu/ops/pallas/qhnet_tp.py `_conv_fwd_kernel` (pallas_call in
// `_conv_run_fwd`): the live pairs, w of their gate products on so2_common.cuh's engine, then
// qhnet_conv_tp_fwd_kernel. Kernel J replaces `_conv_bwd_kernel` (`_conv_run_bwd`): the VJP of
// I for x, h_r, h_s and the weights, as the gate products on the engine around
// qhnet_conv_tp_bwd_kernel. Kernel K replaces `_pair_fwd_kernel` (`_pair_run_fwd`): as I,
// around qhnet_pair_tp_fwd_kernel. Kernel L replaces `_pair_bwd_kernel` (`_pair_run_bwd`): the
// engine's gate products around qhnet_pair_gx_kernel (+ the chunk sum) and
// qhnet_pair_tp_bwd_kernel.
//
// Layouts (as the JAX op): x [B,S,A,C]; cgsh [B,A,A,K]; zi [B,A,Kz,C]; maskf [B,A,A,1];
// h_r [B,A,A,H1], h_s [B,A,A,H2]; W2r [H1,PC], W2s [H2,PC], b2r/b2s [PC]; conv out and its
// cotangent g [B,A,S,C]; pair out and g [B,A,S,A,C]; float32, contiguous, PC = P*C. Every
// entry point takes H1, H2 and PC padded by zeros to multiples of 8 (the engine's K).
//
// What bounds them on the card: the gate's second Dense, 2*(H1+H2) FLOPs per pair, path
// and channel, is most of the work (35 of I's 60 GFLOP and 74 of K's 97 at B=8, A=64,
// C=128, the JAX package's FLOP model); J and L do it three times (u, gh = gu W2^T and
// [gW2; gb2] = [h, 1]^T gu: 125 of L's 162 GFLOP at A=48), and the tensor products add
// ~2*MACS/P per pair, path and channel. Those three are plain dense products, which on this
// card belong on the tensor cores; the tensor products are channel-diagonal contractions
// over <= 9 x 9 Clebsch-Gordan blocks and stay on the CUDA cores. What the design does:
//   * All four: a scan lists the live pairs (cgsh row not zero for I and J, maskf not zero
//     for K and L; a dead pair adds exact zeros to every output) in (b, i, j) order, with
//     each receiver's first row. The gate products run on the engine, 3xTF32 wgmma
//     fp32-accurate within 2e-5, over the live pairs only (gathered h rows) into compact rows
//     [live, PC].
//   * I and K keep one array, w = u_r u_s: u_r (its bias in the epilogue) first, then u_s
//     with an epilogue that adds its bias and multiplies by the u_r row in place (each
//     element read and written by one thread). The tensor-product stage reads w once. Both
//     products have K = H (8-128), so a 128 x 128 tile is mostly set-up and epilogue: they
//     run persistent, one block per SM over all the tiles.
//   * J and L keep u_r and u_s; the tensor-product stage reads them, with no recompute, and
//     overwrites them in place by gu_r = gw u_s, gu_s = gw u_r; then gh = gu W2^T (K = P*C,
//     each 32-deep stage promoted into fp32), scattered to the pair slots, and [gW2; gb2] as
//     fixed-order partials over the live rows. Dead pairs' gh rows stay the caller's zeros.
//   * The tensor-product stages are bound by latency, not by FMAs (few warps per SM, each
//     path's loops up to 9 x 9): each path's body is compiled for its (l, l3) pair (25
//     instances, every loop bound a constant), and the paths are split over blocks.
//     I's runs one block per (b, receiver i, l3 group), the heaviest groups first, over the
//     live senders of i, 4 at a time (their w and x loads in flight together): each block
//     owns its group's output slots (no partials; a receiver with no live pair gets its
//     zeros). K's runs one block per (b, receiver i, KQ live senders, l3 group): each zi
//     load feeds KQ FMAs; the dead pairs' slots stay the caller's zeros.
//     J's runs one block per (b, sender j, eighth of the paths), over the live receivers,
//     with v_a = sum_m cg[a,m] g_m shared by gw = sum_a x_a v_a and gx_a += w v_a (half the
//     FMAs of the forward's order); the eighths' gx partials are summed in a fixed order.
//     L's runs one block per (b, receiver i, quarter of the paths), owning gzi[b,i] on its
//     paths (a sum over j kept in shared memory), 2 live senders at a time.
//   * L's gx (a sum over receivers) runs before that, while u is still there: one block per
//     (b, chunk of receivers, 8 senders), chunks sized for about 16 blocks per SM (>= 1,024
//     at B=8 and A=32/48/64); per l2 group (its body compiled for l2) each thread sums its
//     8 senders' 2l2+1 slots in registers over the chunk, recomputes w = u_r u_s maskf, and
//     each zi load feeds 8 FMAs. The chunks' partials are summed in a fixed order.
//     No stage spills (ptxas: I's stage 128 registers, K's 166, J's 96, L's 168, gx 220).
//   * No float atomics: I-L give the same bits on every run. Padded atoms and masked pairs
//     get exact zeros.

#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

#include "so2_common.cuh"

namespace {

constexpr int NT = 128;         // threads per block: one channel lane each
constexpr int MX = 9;           // largest 2l+1 at LMAX 4
constexpr int MXX = MX * MX;    // largest (2l+1)(2l'+1)
constexpr int MAXP = 65;        // paths at LMAX 4
constexpr int LMAXK = 4;
constexpr int SMAX = (LMAXK + 1) * (LMAXK + 1);
constexpr int LQ = 2;           // senders per register block of L's tensor-product stage
constexpr int L_SPLITS = 4;     // path splits of L's tensor-product stage (blocks per receiver)
constexpr int GQ = 8;           // senders per thread of L's gx stage
constexpr int KQ = 8;           // live senders per block of K's tensor-product stage


__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

struct PathTable {
  int n, cg_used, zi_used;
  int l1[MAXP], l2[MAXP], l3[MAXP], cg_off[MAXP], zi_off[MAXP];
  int by_l3[MAXP];     // path indices grouped by l3, in path order within a group
  int l3_start[LMAXK + 2];
  int by_l2[MAXP];     // and grouped by l2
  int l2_start[LMAXK + 2];
};

// tp_paths(lmax) of the JAX package and the offsets of _cg_layout / _zi_layout;
// call from one thread, then __syncthreads()
__device__ void build_paths(PathTable& t, int lmax) {
  int n = 0, cg = 0, zi = 0;
  for (int l1 = 0; l1 <= lmax; ++l1)
    for (int l2 = 0; l2 <= lmax; ++l2) {
      const int hi = l1 + l2 < lmax ? l1 + l2 : lmax;
      for (int l3 = l1 > l2 ? l1 - l2 : l2 - l1; l3 <= hi; ++l3) {
        t.l1[n] = l1;
        t.l2[n] = l2;
        t.l3[n] = l3;
        t.cg_off[n] = cg;
        t.zi_off[n] = zi;
        cg += (2 * l1 + 1) * (2 * l3 + 1);
        zi += (2 * l2 + 1) * (2 * l3 + 1);
        ++n;
      }
    }
  t.n = n;
  t.cg_used = cg;
  t.zi_used = zi;
  int e = 0, f = 0;
  for (int l = 0; l <= lmax; ++l) {
    t.l3_start[l] = e;
    t.l2_start[l] = f;
    for (int p = 0; p < n; ++p) {
      if (t.l3[p] == l) t.by_l3[e++] = p;
      if (t.l2[p] == l) t.by_l2[f++] = p;
    }
  }
  t.l3_start[lmax + 1] = e;
  t.l2_start[lmax + 1] = f;
}

int n_paths(int lmax) {
  int n = 0;
  for (int l1 = 0; l1 <= lmax; ++l1)
    for (int l2 = 0; l2 <= lmax; ++l2) {
      const int lo = l1 > l2 ? l1 - l2 : l2 - l1, hi = l1 + l2 < lmax ? l1 + l2 : lmax;
      n += hi - lo + 1;
    }
  return n;
}

// columns of the cgsh layout the paths use (cg_used of build_paths)
int cg_columns(int lmax) {
  int n = 0;
  for (int l1 = 0; l1 <= lmax; ++l1)
    for (int l2 = 0; l2 <= lmax; ++l2) {
      const int lo = l1 > l2 ? l1 - l2 : l2 - l1, hi = l1 + l2 < lmax ? l1 + l2 : lmax;
      for (int l3 = lo; l3 <= hi; ++l3) n += (2 * l1 + 1) * (2 * l3 + 1);
    }
  return n;
}

// ---------------------------------------------------------------------------
// the live-pair list
// ---------------------------------------------------------------------------

// flags[e] = 1 when any of the first `used` values of row e of t [npairs, ld] is not zero
// (cgsh's path columns for I and J, maskf for K and L); one warp a row
__global__ void qhnet_flags_kernel(const float* __restrict__ t, int* __restrict__ flags,
                                   long long npairs, int ld, int used) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= npairs) return;  // the whole warp shares w
  bool nz = false;
  for (int k = lane; k < used; k += 32) nz |= __ldg(t + w * ld + k) != 0.f;
  const bool live = __any_sync(0xffffffffu, nz);
  if (lane == 0) flags[w] = live ? 1 : 0;
}

// f.run<L, L2>() for the runtime pair (l, l2), both at most LMAXK: a path's body with
// every loop bound a constant, one instance for each of the 25 pairs
template <int K = 0, class F>
__device__ __forceinline__ void with_ls(int l, int l2, const F& f) {
  if constexpr (K < (LMAXK + 1) * (LMAXK + 1)) {
    if (l * (LMAXK + 1) + l2 == K)
      f.template run<K / (LMAXK + 1), K % (LMAXK + 1)>();
    else
      with_ls<K + 1>(l, l2, f);
  }
}

// f.run<L>() for the runtime l <= LMAXK
template <int K = 0, class F>
__device__ __forceinline__ void with_l(int l, const F& f) {
  if constexpr (K <= LMAXK) {
    if (l == K)
      f.template run<K>();
    else
      with_l<K + 1>(l, f);
  }
}

// ---------------------------------------------------------------------------
// kernel I, tensor-product stage: one block per (molecule b, receiver i, l3 group), the
// heaviest groups (largest l3) first; it owns agg[b,i,l3^2+m] (zeros for a receiver with no
// live pair). Per path of the group, over the live senders j of i (rows rs[bi]..rs[bi+1]):
// agg[l3^2+m] += sum_a cg[a,m] w x_j[l1^2+a], w = u_r u_s of the pair's row.
// ---------------------------------------------------------------------------

// one path of I's stage for one thread's channel, its (l1, l3) at compile time
template <int L3>
struct ConvPathFwd {
  const float* cg_s;  // [live senders][MXX]: the path's cgsh columns
  const int* js;      // the live senders
  const float* xb;    // x + b*S*A*C + c
  const float* wp;    // w + e0*ldu + p*C + c: the path's column of i's first live row
  float (&acc)[2 * L3 + 1];
  int nl, A, C, ldu;
  template <int L1>
  __device__ __forceinline__ void run() const {
    constexpr int N1 = 2 * L1 + 1, M3 = 2 * L3 + 1;
#pragma unroll 4  // the w and x loads of 4 rows in flight together
    for (int n = 0; n < nl; ++n) {
      const float wv = wp[(size_t)n * ldu];
      const float* xj = xb + ((size_t)L1 * L1 * A + js[n]) * C;
      const float* cg = cg_s + n * MXX;
      float xw[N1];
#pragma unroll
      for (int a = 0; a < N1; ++a) xw[a] = wv * xj[(size_t)a * A * C];
#pragma unroll
      for (int m = 0; m < M3; ++m)
#pragma unroll
        for (int a = 0; a < N1; ++a) acc[m] = fmaf(cg[a * M3 + m], xw[a], acc[m]);
    }
  }
};

// one l3 group of I's stage for one thread's channel
struct ConvGroupFwd {
  const PathTable& pt;
  const float* cgsh;  // cgsh + bi*A*K: receiver i's rows
  const float* xb;    // x + b*S*A*C + c
  const float* w;     // w + e0*ldu + c
  const int* js;
  float* cg_s;
  float* ob;  // out + bi*S*C + c
  int nl, A, C, K, ldu, tid;
  bool act;
  template <int L3>
  __device__ __forceinline__ void run() const {
    constexpr int M3 = 2 * L3 + 1;
    float acc[M3];
#pragma unroll
    for (int m = 0; m < M3; ++m) acc[m] = 0.f;
    for (int e = pt.l3_start[L3]; e < pt.l3_start[L3 + 1]; ++e) {
      const int p = pt.by_l3[e], l1 = pt.l1[p], nw = (2 * l1 + 1) * M3;
      __syncthreads();  // the previous path's cg_s is read
      for (int idx = tid; idx < nl * nw; idx += NT) {
        const int n = idx / nw, k = idx - n * nw;
        cg_s[n * MXX + k] = cgsh[(size_t)js[n] * K + pt.cg_off[p] + k];
      }
      __syncthreads();
      with_l(l1, ConvPathFwd<L3>{cg_s, js, xb, w + (size_t)p * C, acc, nl, A, C, ldu});
    }
    if (act)
#pragma unroll
      for (int m = 0; m < M3; ++m) ob[(size_t)(L3 * L3 + m) * C] = acc[m];
  }
};

__host__ __device__ inline size_t conv_tp_fwd_smem(int A) {
  return sizeof(float) * (size_t)A * MXX + sizeof(int) * (size_t)A;
}

__global__ void __launch_bounds__(NT, 4) qhnet_conv_tp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ cgsh, const float* __restrict__ w,
    const int* __restrict__ eidx, const int* __restrict__ rs, float* __restrict__ out, int B,
    int A, int C, int K, int ldu, int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  const int nbi = B * A, bi = blockIdx.x % nbi, l3 = lmax - (int)blockIdx.x / nbi;
  const int b = bi / A, tid = threadIdx.x, S = (lmax + 1) * (lmax + 1);
  const int e0 = rs[bi], nl = rs[bi + 1] - e0;  // the live pairs (b, i, .), rows e0..
  float* cg_s = reinterpret_cast<float*>(smem4);             // [A][MXX]: a path's cgsh columns
  int* js = reinterpret_cast<int*>(cg_s + (size_t)A * MXX);  // [A]: the live senders j
  if (tid == 0) build_paths(pt, lmax);
  for (int n = tid; n < nl; n += NT) js[n] = eidx[e0 + n] - bi * A;
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid, cc = c < C ? c : 0;
    const ConvGroupFwd f{pt, cgsh + (size_t)bi * A * K, x + (size_t)b * S * A * C + cc,
                         w + (size_t)e0 * ldu + cc, js, cg_s, out + (size_t)bi * S * C + cc, nl,
                         A, C, K, ldu, tid, c < C};
    with_l(l3, f);
  }
}

// ---------------------------------------------------------------------------
// kernel K, tensor-product stage: one block per (molecule b, receiver i, tile of KQ live
// senders, l3 group), the blocks of one receiver adjacent (its zi rows stay in L2). Per path
// of the group: fij[b,i,l3^2+m,j] = sum_p sum_b zi[(b,m)] x_j[l2^2+b] w maskf, each zi load
// feeding the tile's KQ senders. The dead pairs' slots are not written (the caller's zeros).
// ---------------------------------------------------------------------------

// one path of K's stage for one thread's channel, its (l2, l3) at compile time
template <int L3>
struct PairPathFwd {
  const float* zp;  // the path's zi rows: zi + (bi*Kz + zi_off)*C + c
  const float* xb;  // x + b*S*A*C + c
  const float* wp;  // w + e0*ldu + p*C + c: the path's column of the tile's first row
  const int (&js)[KQ];
  const float (&mf)[KQ];  // maskf of the tile's senders
  float (&acc)[KQ][2 * L3 + 1];
  int nq, A, C, ldu;
  template <int L2>
  __device__ __forceinline__ void run() const {
    constexpr int N2 = 2 * L2 + 1, M3 = 2 * L3 + 1;
    float wq[KQ];
#pragma unroll
    for (int q = 0; q < KQ; ++q) wq[q] = q < nq ? wp[(size_t)q * ldu] * mf[q] : 0.f;
#pragma unroll 1  // unrolled, the zi loads of all rows are hoisted and the acc registers spill
    for (int bb = 0; bb < N2; ++bb) {
      float xw[KQ];
#pragma unroll
      for (int q = 0; q < KQ; ++q)
        xw[q] = q < nq ? xb[((size_t)(L2 * L2 + bb) * A + js[q]) * C] * wq[q] : 0.f;
#pragma unroll
      for (int m = 0; m < M3; ++m) {
        const float z = __ldg(zp + (size_t)(bb * M3 + m) * C);
#pragma unroll
        for (int q = 0; q < KQ; ++q) acc[q][m] = fmaf(z, xw[q], acc[q][m]);
      }
    }
  }
};

// one l3 group of K's stage for one thread's channel
struct PairGroupFwd {
  const PathTable& pt;
  const float* zi;  // zi + bi*Kz*C + c
  const float* xb;  // x + b*S*A*C + c
  const float* w;   // w + e0*ldu + c
  float* ob;        // out + bi*S*A*C + c
  const int (&js)[KQ];
  const float (&mf)[KQ];
  int nq, A, C, ldu;
  bool act;
  template <int L3>
  __device__ __forceinline__ void run() const {
    constexpr int M3 = 2 * L3 + 1;
    float acc[KQ][M3];
#pragma unroll
    for (int q = 0; q < KQ; ++q)
#pragma unroll
      for (int m = 0; m < M3; ++m) acc[q][m] = 0.f;
    for (int e = pt.l3_start[L3]; e < pt.l3_start[L3 + 1]; ++e) {
      const int p = pt.by_l3[e];
      with_l(pt.l2[p], PairPathFwd<L3>{zi + (size_t)pt.zi_off[p] * C, xb, w + (size_t)p * C, js,
                                       mf, acc, nq, A, C, ldu});
    }
    if (act) {
#pragma unroll
      for (int q = 0; q < KQ; ++q) {
        if (q >= nq) break;
#pragma unroll
        for (int m = 0; m < M3; ++m) ob[((size_t)(L3 * L3 + m) * A + js[q]) * C] = acc[q][m];
      }
    }
  }
};

__global__ void __launch_bounds__(NT) qhnet_pair_tp_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ zi, const float* __restrict__ maskf,
    const float* __restrict__ w, const int* __restrict__ eidx, const int* __restrict__ rs,
    float* __restrict__ out, int A, int C, int Kz, int ldu, int lmax) {
  __shared__ PathTable pt;
  const int ng = lmax + 1, tiles = (A + KQ - 1) / KQ;
  const int bi = blockIdx.x / (ng * tiles), r = blockIdx.x - bi * ng * tiles;
  const int l3 = lmax - r / tiles, t = r - r / tiles * tiles;
  const int e0 = rs[bi] + t * KQ, nq = min(KQ, rs[bi + 1] - e0);
  if (nq <= 0) return;  // past the receiver's live senders: the whole block
  const int b = bi / A, tid = threadIdx.x, S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  int js[KQ];
  float mf[KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q) {
    js[q] = q < nq ? eidx[e0 + q] - bi * A : 0;
    mf[q] = q < nq ? maskf[(size_t)bi * A + js[q]] : 0.f;
  }
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid, cc = c < C ? c : 0;
    const PairGroupFwd f{pt, zi + (size_t)bi * Kz * C + cc, x + (size_t)b * S * A * C + cc,
                         w + (size_t)e0 * ldu + cc, out + (size_t)bi * S * A * C + cc, js, mf,
                         nq, A, C, ldu, c < C};
    with_l(l3, f);
  }
}

// ---------------------------------------------------------------------------
// kernel J, tensor-product stage: one block per (molecule b, sender j, path split sp);
// writes the split's partial gxp[sp,b,:,j]. Over the live receivers i of j, per path:
// v_a = sum_m cg[a,m] g[i,l3^2+m], gw = sum_a x_j[a] v_a, gx[l1^2+a] += w v_a; u_r, u_s of
// the pair's row become gu_r = gw u_s, gu_s = gw u_r in place.
// ---------------------------------------------------------------------------

constexpr int J_SPLITS = 8;  // path splits of J's tensor-product stage (blocks per sender)

// one path of J's stage for one thread's channel, its (l1, l3) at compile time
struct ConvPathBwd {
  const float* cg_s;  // [live receivers][MXX]: the path's cgsh columns
  const int *rows, *recv;
  const float* gb;  // g + b*A*S*C + c
  const float* xj;  // x + (b*S*A + j)*C + c
  float *ur, *us, *gx_s;
  int nl, A, C, S, ldu, col, tid;
  bool act;
  template <int L1, int L3>
  __device__ __forceinline__ void run() const {
    constexpr int N1 = 2 * L1 + 1, M3 = 2 * L3 + 1;
    float xa[N1], gxa[N1];
#pragma unroll
    for (int a = 0; a < N1; ++a) {
      xa[a] = xj[(size_t)(L1 * L1 + a) * A * C];
      gxa[a] = 0.f;
    }
#pragma unroll 1
    for (int n = 0; n < nl; ++n) {
      const size_t at = (size_t)rows[n] * ldu + col;
      const float vr = ur[at], vs = us[at], wv = vr * vs;
      const float* cg = cg_s + n * MXX;
      const float* gi = gb + ((size_t)recv[n] * S + L3 * L3) * C;
      float gm[M3];
#pragma unroll
      for (int m = 0; m < M3; ++m) gm[m] = gi[(size_t)m * C];
      float gw = 0.f;
#pragma unroll
      for (int a = 0; a < N1; ++a) {
        float v = 0.f;
#pragma unroll
        for (int m = 0; m < M3; ++m) v = fmaf(cg[a * M3 + m], gm[m], v);
        gw = fmaf(xa[a], v, gw);
        gxa[a] = fmaf(wv, v, gxa[a]);
      }
      if (act) {
        ur[at] = gw * vs;
        us[at] = gw * vr;
      }
    }
#pragma unroll
    for (int a = 0; a < N1; ++a) gx_s[(L1 * L1 + a) * NT + tid] += gxa[a];
  }
};

__host__ __device__ inline size_t conv_tp_bwd_smem(int A, int S) {
  return sizeof(float) * ((size_t)A * MXX + (size_t)S * NT) + sizeof(int) * 2 * (size_t)A;
}

__global__ void __launch_bounds__(NT) qhnet_conv_tp_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ cgsh, const float* __restrict__ g,
    const int* __restrict__ pos, float* ur, float* us, float* __restrict__ gxp, int B, int A,
    int C, int K, int ldu, int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  __shared__ int n_live;
  const int bj = blockIdx.x / J_SPLITS, sp = blockIdx.x - bj * J_SPLITS;
  const int b = bj / A, j = bj - b * A, tid = threadIdx.x;
  const int S = (lmax + 1) * (lmax + 1);
  float* cg_s = reinterpret_cast<float*>(smem4);             // [A][MXX]: this path's cgsh columns
  float* gx_s = cg_s + (size_t)A * MXX;                      // [S][NT], each thread its own column
  int* recv = reinterpret_cast<int*>(gx_s + (size_t)S * NT);  // the live receivers i
  int* rows = recv + A;                                       // and their pair rows
  if (tid == 0) {
    build_paths(pt, lmax);
    int n = 0;
    for (int i = 0; i < A; ++i) {
      const int e = pos[((size_t)b * A + i) * A + j];
      if (e >= 0) {
        recv[n] = i;
        rows[n++] = e;
      }
    }
    n_live = n;
  }
  __syncthreads();
  const int nl = n_live;
  float* gxb = gxp + ((size_t)sp * B + b) * S * A * C;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int s = 0; s < S; ++s) gx_s[s * NT + tid] = 0.f;
    for (int p = sp; p < pt.n; p += J_SPLITS) {
      const int l1 = pt.l1[p], l3 = pt.l3[p], w = (2 * l1 + 1) * (2 * l3 + 1);
      __syncthreads();  // the previous path's cg_s is read
      for (int idx = tid; idx < nl * w; idx += NT) {
        const int n = idx / w, k = idx - n * w;
        cg_s[n * MXX + k] = cgsh[(((size_t)b * A + recv[n]) * A + j) * K + pt.cg_off[p] + k];
      }
      __syncthreads();
      const ConvPathBwd f{cg_s, rows, recv, g + (size_t)b * A * S * C + cc,
                          x + ((size_t)b * S * A + j) * C + cc, ur, us, gx_s, nl, A, C, S, ldu,
                          p * C + cc, tid, act};
      with_ls(l1, l3, f);
    }
    if (act)
      for (int s = 0; s < S; ++s) gxb[((size_t)s * A + j) * C + c] = gx_s[s * NT + tid];
  }
}

// ---------------------------------------------------------------------------
// kernel L, gx stage (before the tensor-product stage, while u is there): one block per
// (molecule b, chunk of receivers, GQ senders); part[chunk,b,s,j,c] = sum over the chunk's
// receivers i of sum_p sum_m w[b,i,j,p] g[b,i,l3^2+m,j,c] zi[b,i,off_p+bb*m3+m,c], s =
// l2^2+bb, w = u_r u_s maskf recomputed from the gate products' rows. The paths run by l2
// group, each group's slots summed in registers over the chunk (the group's body compiled
// for its l2); each zi load feeds GQ senders.
// ---------------------------------------------------------------------------

// receiver chunks of L's gx stage: the fewest receivers a chunk that still give about
// GX_WAVES blocks per SM (so that the last round of blocks, and the chunks left with few live
// receivers, cost little), no chunk empty
constexpr int GX_WAVES = 16;
int gx_chunks(int B, int A) {
  const int tiles = (A + GQ - 1) / GQ, cap = GX_WAVES * SMS;
  const int per = std::max(1, (A * B * tiles + cap - 1) / cap);
  return (A + per - 1) / per;
}

// one l2 group of L's gx stage for one thread's channel
struct GxGroup {
  const PathTable& pt;
  const float *zi, *g, *maskf, *ur, *us;
  const int* pos;
  float* pb;  // the chunk's partial: part + (chunk*B + b)*S*A*C
  size_t b;
  int i_lo, i_hi, j0, A, C, S, Kz, ldu, cc;
  bool act;
  template <int L2>
  __device__ __forceinline__ void run() const {
    constexpr int N2 = 2 * L2 + 1;
    float acc[GQ][N2];
#pragma unroll
    for (int q = 0; q < GQ; ++q)
#pragma unroll
      for (int bb = 0; bb < N2; ++bb) acc[q][bb] = 0.f;
#pragma unroll 1
    for (int i = i_lo; i < i_hi; ++i) {
      const size_t bi = b * A + i;
      int row[GQ];
      float mf[GQ];
      bool any = false;
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        row[q] = j0 + q < A ? pos[bi * A + j0 + q] : -1;
        mf[q] = row[q] >= 0 ? maskf[bi * A + j0 + q] : 0.f;
        any |= row[q] >= 0;
      }
      if (!any) continue;  // the same for every thread of the block
#pragma unroll 1
      for (int e = pt.l2_start[L2]; e < pt.l2_start[L2 + 1]; ++e) {
        const int p = pt.by_l2[e], l3 = pt.l3[p], m3 = 2 * l3 + 1, col = p * C + cc;
        float w[GQ];
#pragma unroll
        for (int q = 0; q < GQ; ++q)
          w[q] = row[q] >= 0
                     ? ur[(size_t)row[q] * ldu + col] * us[(size_t)row[q] * ldu + col] * mf[q]
                     : 0.f;
        const float* zp = zi + (bi * Kz + pt.zi_off[p]) * C + cc;
        const float* gp = g + ((bi * S + l3 * l3) * A + j0) * C + cc;
#pragma unroll 1
        for (int m = 0; m < m3; ++m) {
          float wg[GQ];
#pragma unroll
          for (int q = 0; q < GQ; ++q)
            wg[q] = row[q] >= 0 ? w[q] * gp[((size_t)m * A + q) * C] : 0.f;
#pragma unroll
          for (int bb = 0; bb < N2; ++bb) {
            const float z = __ldg(zp + (size_t)(bb * m3 + m) * C);
#pragma unroll
            for (int q = 0; q < GQ; ++q) acc[q][bb] = fmaf(wg[q], z, acc[q][bb]);
          }
        }
      }
    }
    if (act) {
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        if (j0 + q >= A) break;
#pragma unroll
        for (int bb = 0; bb < N2; ++bb)
          pb[((size_t)(L2 * L2 + bb) * A + j0 + q) * C + cc] = acc[q][bb];
      }
    }
  }
};

__global__ void __launch_bounds__(NT) qhnet_pair_gx_kernel(
    const float* __restrict__ zi, const float* __restrict__ g, const float* __restrict__ maskf,
    const int* __restrict__ pos, const float* ur, const float* us, float* __restrict__ part,
    int B, int A, int C, int Kz, int ldu, int chunks, int lmax) {
  __shared__ PathTable pt;
  const int tiles = (A + GQ - 1) / GQ, tid = threadIdx.x;
  const int jt = blockIdx.x % tiles, bc = blockIdx.x / tiles;  // blocks of one (b, chunk) adjacent
  const int b = bc / chunks, ch = bc - b * chunks;
  const int per = (A + chunks - 1) / chunks, i_lo = min(A, ch * per), i_hi = min(A, i_lo + per);
  const int S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  __syncthreads();
  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const GxGroup f{pt, zi, g, maskf, ur, us, pos, part + ((size_t)ch * B + b) * S * A * C,
                    (size_t)b, i_lo, i_hi, jt * GQ, A, C, S, Kz, ldu, c < C ? c : 0, c < C};
    for (int l2 = 0; l2 <= lmax; ++l2) with_l(l2, f);
  }
}

// out[idx] = the partials summed in order: the same bits every run
__global__ void qhnet_chunk_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int chunks, long long n) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int ch = 0; ch < chunks; ++ch) s += part[ch * n + idx];
  out[idx] = s;
}

// ---------------------------------------------------------------------------
// kernel L, tensor-product stage: one block per (molecule b, receiver i, path split); owns
// gzi[b,i] on its paths. Per path and LQ live senders: term[q][m] = sum_b zi[(b,m)] x[b][q],
// gw = sum_m term g, gt = w g in the same registers, then gzi[(b,m)] += sum_q gt[q][m]
// x[b][q]; u_r, u_s of the pair's row become gu_r = gw u_s maskf, gu_s = gw u_r maskf in
// place.
// ---------------------------------------------------------------------------

// one path of L's stage for one thread's channel, its (l2, l3) at compile time
struct PairPathBwd {
  const float* zp;  // the path's zi rows: zi + (bi*Kz + zi_off)*C + c
  const float* xb;  // x + b*S*A*C + c
  const float* gi;  // g + bi*S*A*C + c
  const int* js;    // the live senders
  const float* mf_s;
  float *ur, *us, *gz_s;
  int nl, e0, A, C, ldu, col, tid;
  bool act;
  template <int L2, int L3>
  __device__ __forceinline__ void run() const {
    constexpr int N2 = 2 * L2 + 1, M3 = 2 * L3 + 1;
#pragma unroll
    for (int k = 0; k < N2 * M3; ++k) gz_s[k * NT + tid] = 0.f;
    for (int n0 = 0; n0 < nl; n0 += LQ) {
      float xq[LQ][N2], t[LQ][M3], wq[LQ], vr[LQ], vs[LQ], gw[LQ];
      int jq[LQ];
#pragma unroll
      for (int q = 0; q < LQ; ++q) {
        const bool in = n0 + q < nl;
        jq[q] = in ? js[n0 + q] : 0;
        const size_t at = (size_t)(e0 + n0 + q) * ldu + col;
        vr[q] = in ? ur[at] : 0.f;
        vs[q] = in ? us[at] : 0.f;
        wq[q] = vr[q] * vs[q] * (in ? mf_s[n0 + q] : 0.f);
        gw[q] = 0.f;
#pragma unroll
        for (int bb = 0; bb < N2; ++bb)
          xq[q][bb] = in ? xb[((size_t)(L2 * L2 + bb) * A + jq[q]) * C] : 0.f;
#pragma unroll
        for (int m = 0; m < M3; ++m) t[q][m] = 0.f;
      }
      // term[q][m] = sum_b zi[(b,m)] x[l2^2+b][j_q]
#pragma unroll
      for (int bb = 0; bb < N2; ++bb)
#pragma unroll
        for (int m = 0; m < M3; ++m) {
          const float z = __ldg(zp + (size_t)(bb * M3 + m) * C);
#pragma unroll
          for (int q = 0; q < LQ; ++q) t[q][m] = fmaf(z, xq[q][bb], t[q][m]);
        }
      // gw[q] = sum_m term g; t becomes gt = w g
#pragma unroll
      for (int q = 0; q < LQ; ++q) {
        const bool in = n0 + q < nl;
#pragma unroll
        for (int m = 0; m < M3; ++m) {
          const float gm = in ? gi[((size_t)(L3 * L3 + m) * A + jq[q]) * C] : 0.f;
          gw[q] = fmaf(t[q][m], gm, gw[q]);
          t[q][m] = wq[q] * gm;
        }
      }
      // gzi[(b,m)] += sum_q gt[q][m] x[l2^2+b][j_q]
#pragma unroll
      for (int bb = 0; bb < N2; ++bb)
#pragma unroll
        for (int m = 0; m < M3; ++m) {
          float sum = 0.f;
#pragma unroll
          for (int q = 0; q < LQ; ++q) sum = fmaf(t[q][m], xq[q][bb], sum);
          gz_s[(bb * M3 + m) * NT + tid] += sum;
        }
      if (act) {
#pragma unroll
        for (int q = 0; q < LQ; ++q) {
          if (n0 + q >= nl) break;
          const float mf = mf_s[n0 + q];
          const size_t at = (size_t)(e0 + n0 + q) * ldu + col;
          ur[at] = gw[q] * vs[q] * mf;
          us[at] = gw[q] * vr[q] * mf;
        }
      }
    }
  }
};

__host__ __device__ inline size_t pair_tp_bwd_smem(int A) {
  return sizeof(float) * ((size_t)MXX * NT + (size_t)A) + sizeof(int) * (size_t)A;
}

__global__ void __launch_bounds__(NT) qhnet_pair_tp_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ zi, const float* __restrict__ maskf,
    const float* __restrict__ g, const int* __restrict__ eidx, const int* __restrict__ rs,
    float* ur, float* us, float* __restrict__ gzi, int A, int C, int Kz, int ldu, int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  const int bi = blockIdx.x / L_SPLITS, sp = blockIdx.x - bi * L_SPLITS, b = bi / A;
  const int tid = threadIdx.x, S = (lmax + 1) * (lmax + 1);
  const int e0 = rs[bi], nl = rs[bi + 1] - e0;  // the live pairs (b, i, .), rows e0..
  float* gz_s = reinterpret_cast<float*>(smem4);  // [MXX][NT], each thread its own column
  float* mf_s = gz_s + (size_t)MXX * NT;          // [A]: maskf of the live senders
  int* js = reinterpret_cast<int*>(mf_s + A);     // [A]: the live senders j
  if (tid == 0) build_paths(pt, lmax);
  for (int n = tid; n < nl; n += NT) {
    const int j = eidx[e0 + n] - bi * A;
    js[n] = j;
    mf_s[n] = maskf[(size_t)bi * A + j];
  }
  __syncthreads();
  float* gzb = gzi + (size_t)bi * Kz * C;
  // rows of the zi layout no path uses (its padding) get zero cotangents
  if (sp == 0)
    for (int idx = tid; idx < (Kz - pt.zi_used) * C; idx += NT)
      gzb[(size_t)pt.zi_used * C + idx] = 0.f;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int p = sp; p < pt.n; p += L_SPLITS) {
      const int l2 = pt.l2[p], l3 = pt.l3[p], nz = (2 * l2 + 1) * (2 * l3 + 1);
      const PairPathBwd f{zi + ((size_t)bi * Kz + pt.zi_off[p]) * C + cc,
                          x + (size_t)b * S * A * C + cc, g + (size_t)bi * S * A * C + cc, js,
                          mf_s, ur, us, gz_s, nl, e0, A, C, ldu, p * C + cc, tid, act};
      with_ls(l2, l3, f);
      if (act)
        for (int k = 0; k < nz; ++k) gzb[((size_t)pt.zi_off[p] + k) * C + c] = gz_s[k * NT + tid];
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// I-L on the host: the live pairs, the gate products (and their gradients) on the engine
// ---------------------------------------------------------------------------

// what a call carves from its scratch
struct Work {
  float *ur, *us;  // forward: w [max_rows, ldu] in ur; backward: u_r, u_s (then gu_r, gu_s)
  float* gxpart;   // a backward's gx partials
  int *flags, *eidx, *pos, *rs, *n_rows;
  int chunks;  // gx partials: J's path splits, L's receiver chunks
  Engine en;
};

// floats of a forward call (bwd false: one [rows, ldu] array, the engine's prepped weights)
// or of a backward call (two arrays, the weight-gradient partials and the gx partials)
long long scratch_floats(bool bwd, bool pair, int B, int A, int C, int H1, int H2, int lmax) {
  const long long rows = (long long)B * A * A, ldu = round_up(n_paths(lmax) * C, 8);
  const long long S = (lmax + 1) * (lmax + 1), prep = 2 * ldu * (H1 + H2);
  if (!bwd) return rows * ldu + prep;
  const int ch = pair ? gx_chunks(B, A) : J_SPLITS;
  return 2 * rows * ldu + prep + part_bound(ldu) + (ch > 1 ? ch * B * S * A * C : 0);
}

long long scratch_ints(int B, int A) { return 3LL * B * A * A + (long long)B * A + 2; }

Work carve(bool bwd, bool pair, int B, int A, int C, int H1, int H2, int lmax, float* f,
           int* iw) {
  const long long rows = (long long)B * A * A, ldu = round_up(n_paths(lmax) * C, 8);
  Work w{};
  w.ur = f;
  w.us = bwd ? f + rows * ldu : nullptr;
  float* prep = f + (bwd ? 2 : 1) * rows * ldu;
  const long long prep_n = 2 * ldu * (H1 + H2), part_n = bwd ? part_bound(ldu) : 0;
  w.chunks = !bwd ? 0 : pair ? gx_chunks(B, A) : J_SPLITS;
  w.gxpart = w.chunks > 1 ? prep + prep_n + part_n : nullptr;
  w.flags = iw;
  w.eidx = iw + rows;
  w.pos = iw + 2 * rows;
  w.rs = iw + 3 * rows;
  w.n_rows = w.rs + (long long)B * A + 1;
  w.en = Engine{rows, w.n_rows, w.eidx, prep, prep_n, bwd ? prep + prep_n : nullptr, part_n};
  return w;
}

// the live pairs from row flags of t [B*A*A, ld] (its first `used` values)
cudaError_t live_pairs(const Work& w, const float* t, int ld, int used, int B, int A,
                       cudaStream_t st) {
  const long long npairs = (long long)B * A * A;
  qhnet_flags_kernel<<<(unsigned)((npairs * 32 + 255) / 256), 256, 0, st>>>(t, w.flags, npairs,
                                                                           ld, used);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return live_rows(w.flags, w.eidx, w.pos, w.rs, w.n_rows, npairs, A, st);
}

// w = (h_r W2r + b2r)(h_s W2s + b2s) of the live pairs into their compact rows (ur): u_r
// first, then u_s with an epilogue that adds b2s and multiplies by the u_r row in place; both
// persistent (K = H is 8-128: a tile a block would be mostly set-up and epilogue)
cudaError_t gate_weights(const Work& w, const float* hr, const float* hs, const float* w2r,
                         const float* b2r, const float* w2s, const float* b2s, int H1, int H2,
                         int ldu, cudaStream_t st) {
  NNProb pr = prob({seg(hr, H1, w2r, ldu, H1)}, ldu, EPI_GATES, w.ur, ldu);
  NNProb ps = gated(prob({seg(hs, H2, w2s, ldu, H2)}, ldu, EPI_GATED, nullptr, 0, w.ur, ldu),
                    w.ur, ldu);
  pr.gather = ps.gather = 1;
  pr.bias = b2r;
  ps.bias = b2s;
  const cudaError_t err = launch_products(w.en, {pr}, st, true);
  return err != cudaSuccess ? err : launch_products(w.en, {ps}, st, true);
}

// u_r = h_r W2r + b2r and u_s = h_s W2s + b2s of the live pairs, into their compact rows
cudaError_t gate_products(const Work& w, const float* hr, const float* hs, const float* w2r,
                          const float* b2r, const float* w2s, const float* b2s, int H1, int H2,
                          int ldu, cudaStream_t st) {
  NNProb pr = prob({seg(hr, H1, w2r, ldu, H1)}, ldu, EPI_GATES, w.ur, ldu);
  NNProb ps = prob({seg(hs, H2, w2s, ldu, H2)}, ldu, EPI_GATES, w.us, ldu);
  pr.gather = ps.gather = 1;
  pr.bias = b2r;
  ps.bias = b2s;
  return launch_products(w.en, {pr, ps}, st);
}

// from gu_r, gu_s (compact rows): gh = gu W2^T scattered to the pair slots (the dead pairs'
// rows keep the caller's zeros), and gwb = [gW2; gb2] [H+1, ldu] over the live pairs
cudaError_t gate_grads(const Work& w, const float* hr, const float* hs, const float* w2r,
                       const float* w2s, float* ghr, float* ghs, float* gwb_r, float* gwb_s,
                       int H1, int H2, int ldu, cudaStream_t st) {
  NNProb pr = prob({seg(w.ur, ldu, w2r, ldu, ldu, true)}, H1, EPI_STORE, ghr, H1);
  NNProb ps = prob({seg(w.us, ldu, w2s, ldu, ldu, true)}, H2, EPI_STORE, ghs, H2);
  pr.scatter = ps.scatter = 1;
  cudaError_t err = launch_products(w.en, {pr, ps}, st);
  if (err != cudaSuccess) return err;
  const std::vector<TNProb> tp = {
      tprob({TSeg{hr, w.ur, H1, ldu, 1.f}}, A_GATHER, H1, ldu, gwb_r, ldu),
      tprob({TSeg{hs, w.us, H2, ldu, 1.f}}, A_GATHER, H2, ldu, gwb_s, ldu),
      tprob({TSeg{nullptr, w.ur, 0, ldu, 1.f}}, A_ONES, 1, ldu, gwb_r + (size_t)H1 * ldu, ldu),
      tprob({TSeg{nullptr, w.us, 0, ldu, 1.f}}, A_ONES, 1, ldu, gwb_s + (size_t)H2 * ldu, ldu)};
  return launch_wgrads(w.en, tp, st);
}

bool gate_shapes_ok(int H1, int H2, int lmax) {
  return lmax >= 0 && lmax <= LMAXK && H1 > 0 && H2 > 0 && H1 % 8 == 0 && H2 % 8 == 0;
}

}  // namespace

extern "C" {

// float and int scratch of a forward entry point (kernels I and K), for the padded gate
// widths H1, H2 it is given
long long qhnet_fwd_scratch_floats(int B, int A, int C, int H1, int H2, int lmax) {
  return scratch_floats(false, false, B, A, C, H1, H2, lmax);
}

long long qhnet_fwd_scratch_ints(int B, int A) { return scratch_ints(B, A); }

// float and int scratch of a backward entry point (pair 0: kernel J, 1: kernel L), for the
// padded gate widths H1, H2 it is given
long long qhnet_bwd_scratch_floats(int pair, int B, int A, int C, int H1, int H2, int lmax) {
  return scratch_floats(true, pair != 0, B, A, C, H1, H2, lmax);
}

long long qhnet_bwd_scratch_ints(int B, int A) { return scratch_ints(B, A); }

// Each returns a cudaError_t (0 = success), launches on `stream`, does not sync. They take
// the gates padded by zeros: h_r [B,A,A,H1], h_s [B,A,A,H2] with H1, H2 multiples of 8 (else,
// or for lmax above 4, cudaErrorInvalidValue), W2r [H1,ldu], W2s [H2,ldu], b2r, b2s [ldu],
// ldu = P*C rounded up to 8; scratch and iscratch as qhnet_fwd_scratch_floats / _ints (or
// _bwd_) size them.

// kernel I: out [B,A,S,C], every slot written
int qhnet_conv_fwd(const float* x, const float* cgsh, const float* hr, const float* hs,
                   const float* w2r, const float* b2r, const float* w2s, const float* b2s,
                   float* out, float* scratch, int* iscratch, int B, int A, int C, int H1,
                   int H2, int K, int lmax, void* stream) {
  if (!gate_shapes_ok(H1, H2, lmax)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldu = round_up(n_paths(lmax) * C, 8);
  const Work w = carve(false, false, B, A, C, H1, H2, lmax, scratch, iscratch);
  cudaError_t err = live_pairs(w, cgsh, K, cg_columns(lmax), B, A, st);
  if (err == cudaSuccess) err = gate_weights(w, hr, hs, w2r, b2r, w2s, b2s, H1, H2, ldu, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = conv_tp_fwd_smem(A);
  if ((err = set_smem(reinterpret_cast<const void*>(qhnet_conv_tp_fwd_kernel), smem)) !=
      cudaSuccess)
    return (int)err;
  qhnet_conv_tp_fwd_kernel<<<B * A * (lmax + 1), NT, smem, st>>>(x, cgsh, w.ur, w.eidx, w.rs,
                                                                 out, B, A, C, K, ldu, lmax);
  return (int)cudaGetLastError();
}

// kernel K: out [B,A,S,A,C] must hold zeros (only the live pairs' slots are written)
int qhnet_pair_fwd(const float* x, const float* zi, const float* maskf, const float* hr,
                   const float* hs, const float* w2r, const float* b2r, const float* w2s,
                   const float* b2s, float* out, float* scratch, int* iscratch, int B, int A,
                   int C, int H1, int H2, int Kz, int lmax, void* stream) {
  if (!gate_shapes_ok(H1, H2, lmax)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ldu = round_up(n_paths(lmax) * C, 8);
  const Work w = carve(false, true, B, A, C, H1, H2, lmax, scratch, iscratch);
  cudaError_t err = live_pairs(w, maskf, 1, 1, B, A, st);
  if (err == cudaSuccess) err = gate_weights(w, hr, hs, w2r, b2r, w2s, b2s, H1, H2, ldu, st);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (A + KQ - 1) / KQ;
  qhnet_pair_tp_fwd_kernel<<<B * A * (lmax + 1) * tiles, NT, 0, st>>>(
      x, zi, maskf, w.ur, w.eidx, w.rs, out, A, C, Kz, ldu, lmax);
  return (int)cudaGetLastError();
}

// The backward entry points, besides: ghr [B,A,A,H1] and ghs [B,A,A,H2] must hold zeros
// (only the live pairs' rows are written); gwb_r [H1+1, ldu] is gW2r over gb2r (likewise
// gwb_s).
int qhnet_conv_bwd(const float* x, const float* cgsh, const float* hr, const float* hs,
                   const float* w2r, const float* b2r, const float* w2s, const float* b2s,
                   const float* g, float* gx, float* ghr, float* ghs, float* gwb_r, float* gwb_s,
                   float* scratch, int* iscratch, int B, int A, int C, int H1, int H2, int K,
                   int lmax, void* stream) {
  if (!gate_shapes_ok(H1, H2, lmax)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (lmax + 1) * (lmax + 1), ldu = round_up(n_paths(lmax) * C, 8);
  const Work w = carve(true, false, B, A, C, H1, H2, lmax, scratch, iscratch);
  cudaError_t err = live_pairs(w, cgsh, K, cg_columns(lmax), B, A, st);
  if (err == cudaSuccess) err = gate_products(w, hr, hs, w2r, b2r, w2s, b2s, H1, H2, ldu, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = conv_tp_bwd_smem(A, S);
  if ((err = set_smem(reinterpret_cast<const void*>(qhnet_conv_tp_bwd_kernel), smem)) !=
      cudaSuccess)
    return (int)err;
  qhnet_conv_tp_bwd_kernel<<<B * A * J_SPLITS, NT, smem, st>>>(x, cgsh, g, w.pos, w.ur, w.us,
                                                               w.gxpart, B, A, C, K, ldu, lmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long n = (long long)B * S * A * C;
  qhnet_chunk_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(w.gxpart, gx, J_SPLITS, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)gate_grads(w, hr, hs, w2r, w2s, ghr, ghs, gwb_r, gwb_s, H1, H2, ldu, st);
}

// as qhnet_conv_bwd, plus gzi [B,A,Kz,C]
int qhnet_pair_bwd(const float* x, const float* zi, const float* maskf, const float* hr,
                   const float* hs, const float* w2r, const float* b2r, const float* w2s,
                   const float* b2s, const float* g, float* gx, float* gzi, float* ghr,
                   float* ghs, float* gwb_r, float* gwb_s, float* scratch, int* iscratch, int B,
                   int A, int C, int H1, int H2, int Kz, int lmax, void* stream) {
  if (!gate_shapes_ok(H1, H2, lmax)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (lmax + 1) * (lmax + 1), ldu = round_up(n_paths(lmax) * C, 8);
  const Work w = carve(true, true, B, A, C, H1, H2, lmax, scratch, iscratch);
  cudaError_t err = live_pairs(w, maskf, 1, 1, B, A, st);
  if (err == cudaSuccess) err = gate_products(w, hr, hs, w2r, b2r, w2s, b2s, H1, H2, ldu, st);
  if (err != cudaSuccess) return (int)err;
  // gx first: it reads u, which the tensor-product stage then turns into gu
  const int tiles = (A + GQ - 1) / GQ;
  float* part = w.chunks > 1 ? w.gxpart : gx;
  qhnet_pair_gx_kernel<<<B * w.chunks * tiles, NT, 0, st>>>(zi, g, maskf, w.pos, w.ur, w.us, part,
                                                            B, A, C, Kz, ldu, w.chunks, lmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (w.chunks > 1) {
    const long long n = (long long)B * S * A * C;
    qhnet_chunk_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, gx, w.chunks, n);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t smem = pair_tp_bwd_smem(A);
  if ((err = set_smem(reinterpret_cast<const void*>(qhnet_pair_tp_bwd_kernel), smem)) !=
      cudaSuccess)
    return (int)err;
  qhnet_pair_tp_bwd_kernel<<<B * A * L_SPLITS, NT, smem, st>>>(
      x, zi, maskf, g, w.eidx, w.rs, w.ur, w.us, gzi, A, C, Kz, ldu, lmax);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)gate_grads(w, hr, hs, w2r, w2s, ghr, ghs, gwb_r, gwb_s, H1, H2, ldu, st);
}

}  // extern "C"
