// Device code shared by the SO(2) message kernels (csrc/escn_layer.cu, kernels M and N;
// csrc/eqv2_attn.cu, kernels O and P): each source includes it and builds its own copy.
//
//   * so2_gemm_kernel: a grouped product over a list of rows (the live pairs or edges of a
//     batch): C[e, n] = sum over segments of sign * A[row(e), k] B[k, n] (B as [K, N] or
//     transposed), 128 x 128 tiles of fp32 FMA, 8 x 8 outputs a thread, double-buffered
//     k tiles of 16, with a store, bias (+ silu) or gate-multiply epilogue and an optional
//     row gather (A) or scatter (C) through the row list;
//   * so2_wgrad_kernel + so2_wgrad_reduce_kernel: weight gradients out[m, n] = sum over the
//     rows of A[e, m] B[e, n], as SPL partial tiles over a fixed split of the rows, summed in
//     a fixed order (no atomics: the same bits every run);
//   * so2_scan_kernel: the list of live rows from 0/1 flags, in slot order, with the first
//     row of each receiver;
//   * the m-major row tables of the truncated SO(3) stacks (compile-time in L, M), the
//     staging of the truncated S2 grid's tables in shared memory, and silu on that grid
//     (one channel's stack in registers) with its transpose.
// Every product takes K a multiple of 8 and N a multiple of 4, with 16-byte aligned rows.

#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <initializer_list>
#include <vector>

namespace {

constexpr int BM = 128, BN = 128, BK = 16, PADW = BM + 4, GT = 256;
constexpr int SPL = 8;       // row splits of the weight-gradient products
constexpr int NN_MAXP = 8;   // problems per product launch
constexpr int TN_MAXP = 10;  // problems per weight-gradient launch
constexpr int MAXSEG = 4;
constexpr int RT = 128;      // threads of the per-receiver kernels (one channel each)

enum { EPI_STORE = 0, EPI_GATES = 1, EPI_GATED = 2 };

__device__ __forceinline__ float silu(float z) { return z / (1.f + expf(-z)); }
__device__ __forceinline__ float dsilu(float z) {
  const float s = 1.f / (1.f + expf(-z));
  return s * (1.f + z * (1.f - s));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// ---------------------------------------------------------------------------
// products over the live pairs: C[e, n] = sum_k A[e, k] B[k, n]
// ---------------------------------------------------------------------------

struct Seg {
  const float* a;  // row e of A at a + row(e) * lda
  const float* b;  // B [K, N] at b + k * ldb + n, or transposed: b + n * ldb + k
  int lda, ldb, k, btrans;
  float sign;
};

struct NNProb {
  Seg seg[MAXSEG];
  int nseg, gather, scatter, epi, n, ldc, ldc2, ldg;
  float* c;            // EPI_STORE: acc; EPI_GATES: acc + bias; EPI_GATED: acc (null: skip)
  float* c2;           // EPI_GATES: silu(acc + bias); EPI_GATED: acc * gate (null: skip)
  const float* bias;   // [N]
  const float* gate;   // row e at gate + e * ldg
};

struct NNBatch {
  NNProb p[NN_MAXP];
  int np;
  int tile0[NN_MAXP + 1];  // first column tile of each problem (blockIdx.y)
};

// acc[i][j] += As[k][row i] * Bs[k][col j] over the BK slices of one tile
__device__ __forceinline__ void tile_fma(const float (*As)[PADW], const float (*Bs)[PADW],
                                         int ty, int tx, float acc[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// the next k tile of a problem: segment s, offset k0 (false past the last)
__device__ __forceinline__ bool next_tile(const NNProb& P, int& s, int& k0) {
  k0 += BK;
  if (k0 < P.seg[s].k) return true;
  k0 = 0;
  return ++s < P.nseg;
}

// one BM x BN tile of one problem; blockIdx.x the row tile over the live pairs,
// blockIdx.y the (problem, column tile). The k tiles of all segments run as one
// sequence, double-buffered: the next tile's loads are in flight while the
// current one is multiplied.
__global__ void __launch_bounds__(GT, 2) so2_gemm_kernel(const __grid_constant__ NNBatch bt,
                                                          const int* __restrict__ n_rows,
                                                          const int* __restrict__ eidx) {
  __shared__ __align__(16) float As[2][BK][PADW];
  __shared__ __align__(16) float Bs[2][BK][PADW];
  const int nr = *n_rows;
  const int m0 = blockIdx.x * BM;
  if (m0 >= nr) return;
  int pi = 0;
  while (pi + 1 < bt.np && (int)blockIdx.y >= bt.tile0[pi + 1]) ++pi;
  const NNProb& P = bt.p[pi];
  const int n0 = ((int)blockIdx.y - bt.tile0[pi]) * BN;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // loaders: A row ar, k slice ak..ak+7; B (as [K,N]) k row bk, columns bn..bn+7, or
  // (transposed) column tn, k slice ak..ak+7
  const int ar = tid >> 1, ak = (tid & 1) * 8, bk = tid >> 4, bn = (tid & 15) * 8;
  const int grow = m0 + ar;
  const bool a_ok = grow < nr;
  const long long arow = a_ok ? (P.gather ? (long long)eidx[grow] : (long long)grow) : 0;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 ra[2], rb[2];
  float rsign = 1.f;
  int rbt = 0;

  auto load = [&](int s, int k0) {
    const Seg& S = P.seg[s];
    rsign = S.sign;
    rbt = S.btrans;
    const float* ap = S.a + arow * S.lda + k0 + ak;
    // K is a multiple of 8: a k slice of 8 lies wholly inside or outside it
    const bool ak_ok = k0 + ak < S.k;
    ra[0] = a_ok && ak_ok ? ld4(ap) : zero4;
    ra[1] = a_ok && ak_ok ? ld4(ap + 4) : zero4;
    if (!S.btrans) {
      const bool ok = k0 + bk < S.k;
      const float* bp = S.b + (long long)(k0 + bk) * S.ldb + n0 + bn;
      rb[0] = ok && n0 + bn < P.n ? ld4(bp) : zero4;
      rb[1] = ok && n0 + bn + 4 < P.n ? ld4(bp + 4) : zero4;
    } else {
      const int gc = n0 + ar;
      const float* bp = S.b + (long long)gc * S.ldb + k0 + ak;
      rb[0] = ak_ok && gc < P.n ? ld4(bp) : zero4;
      rb[1] = ak_ok && gc < P.n ? ld4(bp + 4) : zero4;
    }
  };
  auto store = [&](int buf) {
    const float a[8] = {ra[0].x, ra[0].y, ra[0].z, ra[0].w, ra[1].x, ra[1].y, ra[1].z, ra[1].w};
#pragma unroll
    for (int q = 0; q < 8; ++q) As[buf][ak + q][ar] = a[q] * rsign;
    if (!rbt) {
      *reinterpret_cast<float4*>(&Bs[buf][bk][bn]) = rb[0];
      *reinterpret_cast<float4*>(&Bs[buf][bk][bn + 4]) = rb[1];
    } else {
      const float b[8] = {rb[0].x, rb[0].y, rb[0].z, rb[0].w, rb[1].x, rb[1].y, rb[1].z, rb[1].w};
#pragma unroll
      for (int q = 0; q < 8; ++q) Bs[buf][ak + q][ar] = b[q];
    }
  };

  int s = 0, k0 = 0, buf = 0;
  load(s, k0);
  store(0);
  __syncthreads();
  for (bool more = true; more;) {
    more = next_tile(P, s, k0);
    if (more) load(s, k0);
    tile_fma(As[buf], Bs[buf], ty, tx, acc);
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= nr) continue;
    const long long orow = P.scatter ? (long long)eidx[r] : (long long)r;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= P.n) continue;
      float4 v = make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                             acc[i][h * 4 + 3]);
      if (P.epi == EPI_STORE) {
        *reinterpret_cast<float4*>(P.c + orow * P.ldc + col) = v;
      } else if (P.epi == EPI_GATES) {
        const float4 bb = ld4(P.bias + col);
        v = make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
        if (P.c) *reinterpret_cast<float4*>(P.c + orow * P.ldc + col) = v;
        if (P.c2)
          *reinterpret_cast<float4*>(P.c2 + orow * P.ldc2 + col) =
              make_float4(silu(v.x), silu(v.y), silu(v.z), silu(v.w));
      } else {
        if (P.c) *reinterpret_cast<float4*>(P.c + orow * P.ldc + col) = v;
        if (P.c2) {
          const float4 g = *reinterpret_cast<const float4*>(P.gate + (long long)r * P.ldg + col);
          *reinterpret_cast<float4*>(P.c2 + orow * P.ldc2 + col) =
              make_float4(v.x * g.x, v.y * g.y, v.z * g.z, v.w * g.w);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradients: out[m, n] = sum over the live pairs e of A[e, m] B[e, n], as SPL
// partial tiles (a fixed split of the pair rows) and a fixed-order sum
// ---------------------------------------------------------------------------

enum { A_ROWS = 0, A_GATHER = 1, A_ONES = 2 };

struct TSeg {
  const float* a;  // row e at a + row(e) * lda (A_GATHER: row(e) = eidx[e])
  const float* b;  // row e at b + e * ldb
  int lda, ldb;
  float sign;
};

struct TNProb {
  TSeg seg[2];
  int nseg, amode, m, n, ldo, tiles_n, ntiles;
  float* out;
  long long part;  // offset of its partial tiles in the partial buffer (floats)
};

struct TNBatch {
  TNProb p[TN_MAXP];
  int np;
  int tile0[TN_MAXP + 1];
};

__device__ __forceinline__ int tn_problem(const TNBatch& bt, int t) {
  int pi = 0;
  while (pi + 1 < bt.np && t >= bt.tile0[pi + 1]) ++pi;
  return pi;
}

__global__ void __launch_bounds__(GT, 2) so2_wgrad_kernel(const __grid_constant__ TNBatch bt,
                                                           const int* __restrict__ n_rows,
                                                           const int* __restrict__ eidx,
                                                           float* __restrict__ part) {
  __shared__ __align__(16) float As[2][BK][PADW];
  __shared__ __align__(16) float Bs[2][BK][PADW];
  const int pi = tn_problem(bt, blockIdx.x);
  const TNProb& P = bt.p[pi];
  const int tl = blockIdx.x - bt.tile0[pi], sp = blockIdx.y;
  const int m0 = (tl / P.tiles_n) * BM, n0 = (tl % P.tiles_n) * BN;
  const int nr = *n_rows;
  const int chunk = ((nr + SPL - 1) / SPL + BK - 1) / BK * BK;
  const int lo = min(nr, sp * chunk), hi = min(nr, lo + chunk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int le = tid >> 4, lc = (tid & 15) * 8;  // loader: pair row le of the tile, columns lc..
  const int gm = m0 + lc, gn = n0 + lc;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float4 ra[2], rb[2];

  auto load = [&](int s, int e0) {
    const TSeg& S = P.seg[s];
    const int row = e0 + le;
    const bool ok = row < hi;
    ra[0] = ra[1] = zero4;
    if (P.amode == A_ONES) {
      if (ok && gm == 0) ra[0].x = S.sign;
    } else if (ok) {
      const long long arow = P.amode == A_GATHER ? (long long)eidx[row] : (long long)row;
      const float* ap = S.a + arow * S.lda + gm;
      if (gm < P.m) ra[0] = ld4(ap);
      if (gm + 4 < P.m) ra[1] = ld4(ap + 4);
      ra[0] = make_float4(ra[0].x * S.sign, ra[0].y * S.sign, ra[0].z * S.sign, ra[0].w * S.sign);
      ra[1] = make_float4(ra[1].x * S.sign, ra[1].y * S.sign, ra[1].z * S.sign, ra[1].w * S.sign);
    }
    const float* bp = S.b + (long long)row * S.ldb + gn;
    rb[0] = ok && gn < P.n ? ld4(bp) : zero4;
    rb[1] = ok && gn + 4 < P.n ? ld4(bp + 4) : zero4;
  };
  auto store = [&](int buf) {
    *reinterpret_cast<float4*>(&As[buf][le][lc]) = ra[0];
    *reinterpret_cast<float4*>(&As[buf][le][lc + 4]) = ra[1];
    *reinterpret_cast<float4*>(&Bs[buf][le][lc]) = rb[0];
    *reinterpret_cast<float4*>(&Bs[buf][le][lc + 4]) = rb[1];
  };

  if (lo < hi) {
    int s = 0, e0 = lo, buf = 0;
    load(s, e0);
    store(0);
    __syncthreads();
    for (bool more = true; more;) {
      e0 += BK;
      if (e0 >= hi) {
        e0 = lo;
        ++s;
      }
      more = s < P.nseg;
      if (more) load(s, e0);
      tile_fma(As[buf], Bs[buf], ty, tx, acc);
      if (more) store(buf ^ 1);
      __syncthreads();
      buf ^= 1;
    }
  }
  float* o = part + P.part + ((long long)tl * SPL + sp) * BM * BN;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(o + r * BN + h * 64 + tx * 4) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
  }
}

// out = the SPL partial tiles summed in order: the same bits every run
__global__ void __launch_bounds__(GT) so2_wgrad_reduce_kernel(const __grid_constant__ TNBatch bt,
                                                               const float* __restrict__ part) {
  const int pi = tn_problem(bt, blockIdx.x);
  const TNProb& P = bt.p[pi];
  const int tl = blockIdx.x - bt.tile0[pi];
  const int m0 = (tl / P.tiles_n) * BM, n0 = (tl % P.tiles_n) * BN;
  const float* src = part + P.part + (long long)tl * SPL * BM * BN;
  for (int el = threadIdx.x; el < BM * BN; el += GT) {
    const int gm = m0 + el / BN, gn = n0 + el % BN;
    if (gm >= P.m || gn >= P.n) continue;
    float s = 0.f;
    for (int q = 0; q < SPL; ++q) s += src[(long long)q * BM * BN + el];
    P.out[(long long)gm * P.ldo + gn] = s;
  }
}

// ---------------------------------------------------------------------------
// the live-row list: one block scans the 0/1 flags in slot order
// ---------------------------------------------------------------------------

// eidx[e] = the e-th live pair, pos[p] = its slot or -1, rs[b*A+i] = the first slot of
// receiver (b, i) (rs[B*A] = the count), n_rows = the count
__global__ void __launch_bounds__(1024) so2_scan_kernel(const int* __restrict__ flags,
                                                         int* __restrict__ eidx,
                                                         int* __restrict__ pos,
                                                         int* __restrict__ rs,
                                                         int* __restrict__ n_rows, int npairs,
                                                         int A) {
  __shared__ int sums[1024];
  const int tid = threadIdx.x;
  const int per = (npairs + 1023) / 1024;
  const int lo = min(npairs, tid * per), hi = min(npairs, lo + per);
  int cnt = 0;
  for (int p = lo; p < hi; ++p) cnt += flags[p];
  sums[tid] = cnt;
  __syncthreads();
  for (int off = 1; off < 1024; off *= 2) {
    const int v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int ex = sums[tid] - cnt;
  for (int p = lo; p < hi; ++p) {
    if (p % A == 0) rs[p / A] = ex;
    if (flags[p]) {
      pos[p] = ex;
      eidx[ex++] = p;
    } else {
      pos[p] = -1;
    }
  }
  if (tid == 1023) {
    n_rows[0] = sums[1023];
    rs[npairs / A] = sums[1023];
  }
}

// ---------------------------------------------------------------------------
// per-receiver stages; L and M are compile-time so the stacks stay in registers
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int mclip(int l, int M) { return l < M ? l : M; }

__host__ __device__ constexpr int s_trunc(int L, int M) {
  int s = 0;
  for (int l = 0; l <= L; ++l) s += 2 * mclip(l, M) + 1;
  return s;
}

// offset of D^l's truncated rows in the compact Wigner row
__host__ __device__ constexpr int k_off(int l, int M) {
  int o = 0;
  for (int q = 0; q < l; ++q) o += (2 * mclip(q, M) + 1) * (2 * q + 1);
  return o;
}

// (l, m) of m-major row r: m=0 (l=0..L), then +m and -m (l=m..L) for m=1..M
__host__ __device__ constexpr int row_l(int L, int M, int r) {
  if (r <= L) return r;
  r -= L + 1;
  for (int a = 1; a <= M; ++a) {
    const int n = L + 1 - a;
    if (r < n) return a + r;
    r -= n;
    if (r < n) return a + r;
    r -= n;
  }
  return -1;
}

__host__ __device__ constexpr int row_m(int L, int M, int r) {
  if (r <= L) return 0;
  r -= L + 1;
  for (int a = 1; a <= M; ++a) {
    const int n = L + 1 - a;
    if (r < n) return a;
    r -= n;
    if (r < n) return -a;
    r -= n;
  }
  return 0;
}

// compact index of D^l[m, col] is row_base(r) + col
__host__ __device__ constexpr int row_base(int L, int M, int r) {
  return k_off(row_l(L, M, r), M) +
         (row_m(L, M, r) + mclip(row_l(L, M, r), M)) * (2 * row_l(L, M, r) + 1);
}

// the grid tables in shared memory: to_g [P][S_t] and from_g transposed, [P][S_t]
__device__ __forceinline__ void stage_grid(const float* __restrict__ tog,
                                           const float* __restrict__ fromg, int P, int ST,
                                           float* tab) {
  for (int idx = threadIdx.x; idx < P * ST; idx += blockDim.x) {
    const int q = idx / ST, r = idx - q * ST;
    tab[idx] = tog[idx];
    tab[P * ST + idx] = fromg[r * P + q];
  }
  __syncthreads();
}

// silu on the truncated S2 grid of one channel's m-major stack m (tab as stage_grid
// leaves it): m2 += from_g silu(to_g m)
template <int ST>
__device__ __forceinline__ void grid_silu(const float* tab, int P, const float (&m)[ST],
                                          float (&m2)[ST]) {
  const float* fT = tab + P * ST;
  for (int q = 0; q < P; ++q) {
    float z = 0.f;
#pragma unroll
    for (int r = 0; r < ST; ++r) z = fmaf(tab[q * ST + r], m[r], z);
    const float a = silu(z);
#pragma unroll
    for (int r = 0; r < ST; ++r) m2[r] = fmaf(fT[q * ST + r], a, m2[r]);
  }
}

// its transpose, given the cotangent gm2 of its output: gm += to_g^T (silu'(to_g m) *
// from_g^T gm2), the grid's pre-activations recomputed from m
template <int ST>
__device__ __forceinline__ void grid_silu_bwd(const float* tab, int P, const float (&m)[ST],
                                              const float (&gm2)[ST], float (&gm)[ST]) {
  const float* fT = tab + P * ST;
  for (int q = 0; q < P; ++q) {
    float z = 0.f, gp = 0.f;
#pragma unroll
    for (int r = 0; r < ST; ++r) {
      z = fmaf(tab[q * ST + r], m[r], z);
      gp = fmaf(fT[q * ST + r], gm2[r], gp);
    }
    const float gpre = gp * dsilu(z);
#pragma unroll
    for (int r = 0; r < ST; ++r) gm[r] = fmaf(tab[q * ST + r], gpre, gm[r]);
  }
}

// ---------------------------------------------------------------------------
// host side: problem lists and their launches
// ---------------------------------------------------------------------------

Seg seg(const float* a, int lda, const float* b, int ldb, int k, bool btrans = false,
        float sign = 1.f) {
  return Seg{a, b, lda, ldb, k, btrans ? 1 : 0, sign};
}

NNProb prob(std::initializer_list<Seg> segs, int n, int epi, float* c, int ldc,
            float* c2 = nullptr, int ldc2 = 0) {
  NNProb p{};
  for (const Seg& s : segs) p.seg[p.nseg++] = s;
  p.n = n;
  p.epi = epi;
  p.c = c;
  p.ldc = ldc;
  p.c2 = c2;
  p.ldc2 = ldc2;
  return p;
}

NNProb gated(NNProb p, const float* gate, int ldg) {
  p.gate = gate;
  p.ldg = ldg;
  return p;
}

// the products over rows 0..*n_rows-1 of at most max_rows (blocks past the count exit)
cudaError_t launch_products(long long max_rows, const int* n_rows, const int* eidx,
                            const std::vector<NNProb>& probs, cudaStream_t st) {
  for (size_t i0 = 0; i0 < probs.size(); i0 += NN_MAXP) {
    NNBatch bt{};
    bt.np = (int)std::min(probs.size() - i0, (size_t)NN_MAXP);
    int t = 0;
    for (int k = 0; k < bt.np; ++k) {
      bt.p[k] = probs[i0 + k];
      bt.tile0[k] = t;
      t += (bt.p[k].n + BN - 1) / BN;
    }
    bt.tile0[bt.np] = t;
    const dim3 grid((unsigned)((max_rows + BM - 1) / BM), (unsigned)t);
    so2_gemm_kernel<<<grid, GT, 0, st>>>(bt, n_rows, eidx);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

TNProb tprob(std::initializer_list<TSeg> segs, int amode, int m, int n, float* out, int ldo) {
  TNProb p{};
  for (const TSeg& s : segs) p.seg[p.nseg++] = s;
  p.amode = amode;
  p.m = m;
  p.n = n;
  p.out = out;
  p.ldo = ldo;
  p.tiles_n = (n + BN - 1) / BN;
  p.ntiles = ((m + BM - 1) / BM) * p.tiles_n;
  return p;
}

// `part` holds the partial tiles of the largest launch (at most TN_MAXP problems)
cudaError_t launch_wgrads(const int* n_rows, const int* eidx, float* part,
                          const std::vector<TNProb>& probs, cudaStream_t st) {
  for (size_t i0 = 0; i0 < probs.size(); i0 += TN_MAXP) {
    TNBatch bt{};
    bt.np = (int)std::min(probs.size() - i0, (size_t)TN_MAXP);
    int t = 0;
    long long off = 0;
    for (int k = 0; k < bt.np; ++k) {
      bt.p[k] = probs[i0 + k];
      bt.p[k].part = off;
      off += (long long)bt.p[k].ntiles * SPL * BM * BN;
      bt.tile0[k] = t;
      t += bt.p[k].ntiles;
    }
    bt.tile0[bt.np] = t;
    so2_wgrad_kernel<<<dim3((unsigned)t, SPL), GT, 0, st>>>(bt, n_rows, eidx, part);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    so2_wgrad_reduce_kernel<<<t, GT, 0, st>>>(bt, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

int receiver_threads(int C) { return C >= RT ? RT : (C + 31) / 32 * 32; }

}  // namespace
