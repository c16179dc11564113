// Fused QHNet tensor-product kernels for Hopper (sm_90a), fp32 FMA.
//
// Per molecule b, receiver i and sender j, the gate MLPs' second Dense gives
// the path weights of the 65 tensor-product paths (l1, l2, l3) at LMAX 4:
//   u_r = h_r[b,i,j] @ W2r + b2r     u_s = h_s[b,i,j] @ W2s + b2s     w = u_r * u_s   [P*C]
//   conv: agg[b,i,l3^2+m,c] = sum_j sum_p sum_a cgsh[b,i,j,off_p+a*(2l3+1)+m] x[b,l1^2+a,j,c] w[pC+c]
//   pair: fij[b,i,l3^2+m,j,c] = sum_p w[pC+c] maskf[b,i,j] sum_b zi[b,i,off_p+b*(2l3+1)+m,c] x[b,l2^2+b,j,c]
//
// Kernel I, qhnet_conv_fwd_kernel, replaces nabladft_tpu/ops/pallas/qhnet_tp.py
// `_conv_fwd_kernel` (pallas_call in `_conv_run_fwd`). Kernel J, qhnet_conv_bwd_kernel
// + the two products below, replaces `_conv_bwd_kernel` (`_conv_run_bwd`): the VJP of I
// for x, h_r, h_s and the weights. Kernel K, qhnet_pair_fwd_kernel, replaces
// `_pair_fwd_kernel` (`_pair_run_fwd`). Kernel L, qhnet_pair_bwd_kernel +
// qhnet_pair_gx_kernel + the products, replaces `_pair_bwd_kernel` (`_pair_run_bwd`).
//
// Layouts (as the JAX op): x [B,S,A,C]; cgsh [B,A,A,K]; zi [B,A,Kz,C]; maskf [B,A,A,1];
// h_r [B,A,A,H1], h_s [B,A,A,H2]; W2r [H1,PC], W2s [H2,PC], b2r/b2s [PC]; conv out and its
// cotangent g [B,A,S,C]; pair out and g [B,A,S,A,C]; float32, contiguous, PC = P*C.
//
// What bounds them on the card: the gate's second Dense, 2*(H1+H2) FLOPs per pair, path
// and channel, is most of the work (35 of I's 60 GFLOP and 74 of K's 97 at B=8, A=64,
// C=128, the JAX package's FLOP model); the tensor products add ~2*MACS/P per pair,
// path and channel. At ~1.8 TFLOP per train step against a few GB of traffic, all four
// are bound by the fp32 FMA rate. What the design does about it:
//   * The Pallas kernel keeps u_r, u_s [A, P*C] (2.1 MB each at A=64) and cgsh's [A, K]
//     row (590 KB) in VMEM; a Hopper block has 227 KB. So each block tiles over paths
//     and neighbours: per path, the block forms w for 8 neighbours at a time in registers
//     (each thread owns one channel; one W2 column load feeds 8 FMAs, the neighbours'
//     hidden rows sit in shared memory) and folds it straight into the tensor product.
//     w never reaches device memory on the forward path.
//   * Per path, only that path's cgsh columns ([A] x (2l1+1)(2l3+1) <= 81) are staged
//     in shared memory. Loops over a, b, m run to the largest 2l+1 (9) under a guard, so
//     per-thread arrays keep constant indices and stay in registers; the 65 paths are a
//     runtime loop over a path table each block builds in shared memory, not 65 bodies.
//   * I and K own their outputs, no atomics. I runs one block per (b, receiver i) and
//     sums over paths grouped by l3 in registers; K runs one block per (b, receiver i,
//     16 senders), so that a bucket of 64 atoms still fills the card in even waves, and
//     keeps [8 senders] x [2l3+1] sums, each zi load feeding 8 senders.
//   * J and L sum over receivers (gx) and over all pairs (the weight gradients); Hopper
//     blocks cannot carry sums across a grid as the TPU does. J's main kernel runs one
//     block per (b, sender j) and owns gx[b,:,j]; L's main kernel runs per (b, receiver
//     i) and owns gzi[b,i] (a sum over j), and a second kernel per (b, 8 senders) owns
//     gx, its paths grouped by l2 so that each output slot's sum stays in registers. The main kernels write gu_r = gw*u_s and gu_s = gw*u_r per pair to scratch
//     ([B,A,A,PC] each; L also the masked w); hand-written fp32 products then give
//     gh = gu @ W2^T (one writer per output) and [gW2; gb2] = [h, 1]^T gu as one partial
//     per (molecule, quarter of its pairs), summed in a fixed order. No float atomics:
//     J and L give the same bits on every run.
//   * Masks: the conv's adjacency reaches I only through cgsh (premasked), so dead pairs
//     give t = 0 and exact zero cotangents; the pair's w is multiplied by maskf, so
//     masked pairs write exact zeros. Padded neighbour rows beyond A are skipped.
// Plain FMA only: no TF32, no tensor cores (the Hamiltonian targets sit below TF32's
// mantissa).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 128;         // threads per block: one channel lane each
constexpr int JB = 8;           // neighbour rows per register block (gate products)
constexpr int MX = 9;           // largest 2l+1 at LMAX 4
constexpr int MXX = MX * MX;    // largest (2l+1)(2l'+1)
constexpr int MAXP = 65;        // paths at LMAX 4
constexpr int LMAXK = 4;
constexpr int GX_JT = 8;        // senders per block of the pair gx kernel
constexpr int GW_NT = 64;       // output columns per block of the weight-gradient kernel
constexpr int GW_PT = 16;       // pairs per shared-memory chunk
constexpr int GW_SPLITS = 4;    // pair slices per molecule (partials per molecule)

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

// acc[q] += sum_k rows[(row0+q)*ld + k] * wcol[k*ldw] for q < JB; ld % 4 == 0, rows
// zero padded for k in [K, ld) and to whole JB blocks
__device__ inline void row_block_dot(const float* __restrict__ rows, int row0, int ld, int K,
                                     const float* __restrict__ wcol, int ldw, float acc[JB]) {
  for (int k = 0; k < ld; k += 4) {
    const float w0 = k < K ? __ldg(wcol + (size_t)k * ldw) : 0.f;
    const float w1 = k + 1 < K ? __ldg(wcol + (size_t)(k + 1) * ldw) : 0.f;
    const float w2 = k + 2 < K ? __ldg(wcol + (size_t)(k + 2) * ldw) : 0.f;
    const float w3 = k + 3 < K ? __ldg(wcol + (size_t)(k + 3) * ldw) : 0.f;
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(rows + (size_t)(row0 + q) * ld + k);
      acc[q] = fmaf(x.x, w0, acc[q]);
      acc[q] = fmaf(x.y, w1, acc[q]);
      acc[q] = fmaf(x.z, w2, acc[q]);
      acc[q] = fmaf(x.w, w3, acc[q]);
    }
  }
}

// dst[r*Hp + h] = src[base + r*rstride + h] for r < n, h < H; zero up to [np][Hp]
__device__ inline void stage_rows(const float* __restrict__ src, size_t base, size_t rstride,
                                  int n, int H, int Hp, int np, float* dst) {
  for (int idx = threadIdx.x; idx < np * Hp; idx += blockDim.x) {
    const int r = idx / Hp, h = idx - r * Hp;
    dst[idx] = (r < n && h < H) ? src[base + (size_t)r * rstride + h] : 0.f;
  }
}

// the gate rows of one block: [Ap][H1p] h_r rows, [Ap][H2p] h_s rows
struct GateRows {
  float *hr, *hs;
  int H1p, H2p;
};

__device__ inline GateRows stage_gate_rows(const float* hr, const float* hs, size_t base1,
                                           size_t base2, size_t stride1, size_t stride2, int A,
                                           int H1, int H2, float* smem) {
  const int Ap = round_up(A, JB);
  GateRows g{smem, smem + (size_t)Ap * round_up(H1, 4), round_up(H1, 4), round_up(H2, 4)};
  stage_rows(hr, base1, stride1, A, H1, g.H1p, Ap, g.hr);
  stage_rows(hs, base2, stride2, A, H2, g.H2p, Ap, g.hs);
  return g;
}

__host__ __device__ inline size_t gate_floats(int A, int H1, int H2) {
  return (size_t)round_up(A, JB) * (round_up(H1, 4) + round_up(H2, 4));
}

// u_r, u_s of rows row0..row0+7 for weight column col (biases added)
__device__ inline void gate_block(const GateRows& g, int row0, int H1, int H2,
                                  const float* __restrict__ w2r, const float* __restrict__ b2r,
                                  const float* __restrict__ w2s, const float* __restrict__ b2s,
                                  int col, int PC, float ur[JB], float us[JB]) {
#pragma unroll
  for (int q = 0; q < JB; ++q) ur[q] = us[q] = 0.f;
  row_block_dot(g.hr, row0, g.H1p, H1, w2r + col, PC, ur);
  row_block_dot(g.hs, row0, g.H2p, H2, w2s + col, PC, us);
  const float br = __ldg(b2r + col), bs = __ldg(b2s + col);
#pragma unroll
  for (int q = 0; q < JB; ++q) {
    ur[q] += br;
    us[q] += bs;
  }
}

// ---------------------------------------------------------------------------
// kernel I: one block per (molecule b, receiver i)
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t conv_fwd_smem(int A, int H1, int H2) {
  return sizeof(float) * (gate_floats(A, H1, H2) + (size_t)A * MXX);
}

__global__ void __launch_bounds__(NT) qhnet_conv_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ cgsh, const float* __restrict__ hr,
    const float* __restrict__ hs, const float* __restrict__ w2r, const float* __restrict__ b2r,
    const float* __restrict__ w2s, const float* __restrict__ b2s, float* __restrict__ out, int A,
    int C, int H1, int H2, int K, int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  float* smem = reinterpret_cast<float*>(smem4);
  const int bi = blockIdx.x, b = bi / A, tid = threadIdx.x, S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  const GateRows gr = stage_gate_rows(hr, hs, (size_t)bi * A * H1, (size_t)bi * A * H2, H1, H2,
                                      A, H1, H2, smem);
  float* cg_s = smem + gate_floats(A, H1, H2);  // [A][MXX]: this path's cgsh columns
  __syncthreads();
  const int PC = pt.n * C;
  const float* xb = x + (size_t)b * S * A * C;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int l3 = 0; l3 <= lmax; ++l3) {
      const int m3 = 2 * l3 + 1;
      float acc[MX];
#pragma unroll
      for (int m = 0; m < MX; ++m) acc[m] = 0.f;
      for (int e = pt.l3_start[l3]; e < pt.l3_start[l3 + 1]; ++e) {
        const int p = pt.by_l3[e], l1 = pt.l1[p], n1 = 2 * l1 + 1, w = n1 * m3;
        __syncthreads();  // the previous path's cg_s is read
        for (int idx = tid; idx < A * w; idx += NT) {
          const int j = idx / w, k = idx - j * w;
          cg_s[j * MXX + k] = cgsh[((size_t)bi * A + j) * K + pt.cg_off[p] + k];
        }
        __syncthreads();
        const int col = p * C + cc;
        for (int j0 = 0; j0 < A; j0 += JB) {
          float ur[JB], us[JB];
          gate_block(gr, j0, H1, H2, w2r, b2r, w2s, b2s, col, PC, ur, us);
#pragma unroll
          for (int q = 0; q < JB; ++q) {
            const int j = j0 + q;
            if (j >= A) break;
            const float wv = ur[q] * us[q];
            float xa[MX];
#pragma unroll
            for (int a = 0; a < MX; ++a)
              xa[a] = a < n1 ? xb[((size_t)(l1 * l1 + a) * A + j) * C + cc] : 0.f;
            const float* cg = cg_s + j * MXX;
#pragma unroll
            for (int m = 0; m < MX; ++m) {
              if (m >= m3) break;
              float t = 0.f;
#pragma unroll
              for (int a = 0; a < MX; ++a)
                if (a < n1) t = fmaf(cg[a * m3 + m], xa[a], t);
              acc[m] = fmaf(t, wv, acc[m]);
            }
          }
        }
      }
      if (act)
        for (int m = 0; m < m3; ++m) out[((size_t)bi * S + l3 * l3 + m) * C + c] = acc[m];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel J, main stage: one block per (molecule b, sender j); owns gx[b,:,j] and
// writes gu_r, gu_s of every pair (b, i, j)
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t conv_bwd_smem(int A, int H1, int H2, int S) {
  return sizeof(float) * (gate_floats(A, H1, H2) + (size_t)A * MXX + (size_t)S * NT);
}

__global__ void __launch_bounds__(NT) qhnet_conv_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ cgsh, const float* __restrict__ hr,
    const float* __restrict__ hs, const float* __restrict__ w2r, const float* __restrict__ b2r,
    const float* __restrict__ w2s, const float* __restrict__ b2s, const float* __restrict__ g,
    float* __restrict__ gx, float* __restrict__ gu_r, float* __restrict__ gu_s, int A, int C,
    int H1, int H2, int K, int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  float* smem = reinterpret_cast<float*>(smem4);
  const int bj = blockIdx.x, b = bj / A, j = bj - b * A, tid = threadIdx.x;
  const int S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  const size_t col0 = (size_t)b * A * A + j;  // pair (b, i, j) = col0 + i * A
  const GateRows gr = stage_gate_rows(hr, hs, col0 * H1, col0 * H2, (size_t)A * H1,
                                      (size_t)A * H2, A, H1, H2, smem);
  float* cg_s = smem + gate_floats(A, H1, H2);  // [A][MXX] over receivers i
  float* gx_s = cg_s + (size_t)A * MXX;         // [S][NT], each thread its own column
  __syncthreads();
  const int PC = pt.n * C;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int s = 0; s < S; ++s) gx_s[s * NT + tid] = 0.f;
    for (int p = 0; p < pt.n; ++p) {
      const int l1 = pt.l1[p], l3 = pt.l3[p], n1 = 2 * l1 + 1, m3 = 2 * l3 + 1, w = n1 * m3;
      __syncthreads();
      for (int idx = tid; idx < A * w; idx += NT) {
        const int i = idx / w, k = idx - i * w;
        cg_s[i * MXX + k] = cgsh[(col0 + (size_t)i * A) * K + pt.cg_off[p] + k];
      }
      __syncthreads();
      float xa[MX], gxa[MX];
#pragma unroll
      for (int a = 0; a < MX; ++a) {
        xa[a] = a < n1 ? x[(((size_t)b * S + l1 * l1 + a) * A + j) * C + cc] : 0.f;
        gxa[a] = 0.f;
      }
      const int col = p * C + cc;
      for (int i0 = 0; i0 < A; i0 += JB) {
        float ur[JB], us[JB];
        gate_block(gr, i0, H1, H2, w2r, b2r, w2s, b2s, col, PC, ur, us);
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int i = i0 + q;
          if (i >= A) break;
          const float wv = ur[q] * us[q];
          const float* cg = cg_s + i * MXX;
          const float* gi = g + (((size_t)b * A + i) * S + l3 * l3) * C + cc;
          float gw = 0.f;
#pragma unroll
          for (int m = 0; m < MX; ++m) {
            if (m >= m3) break;
            const float gm = gi[(size_t)m * C];
            float t = 0.f;
#pragma unroll
            for (int a = 0; a < MX; ++a)
              if (a < n1) t = fmaf(cg[a * m3 + m], xa[a], t);
            gw = fmaf(t, gm, gw);
            const float gt = wv * gm;
#pragma unroll
            for (int a = 0; a < MX; ++a)
              if (a < n1) gxa[a] = fmaf(gt, cg[a * m3 + m], gxa[a]);
          }
          if (act) {
            const size_t at = (col0 + (size_t)i * A) * PC + col;
            gu_r[at] = gw * us[q];
            gu_s[at] = gw * ur[q];
          }
        }
      }
#pragma unroll
      for (int a = 0; a < MX; ++a)
        if (a < n1) gx_s[(l1 * l1 + a) * NT + tid] += gxa[a];
    }
    if (act)
      for (int s = 0; s < S; ++s) gx[(((size_t)b * S + s) * A + j) * C + c] = gx_s[s * NT + tid];
  }
}

// ---------------------------------------------------------------------------
// kernel K: one block per (molecule b, receiver i, tile of KJ senders)
// ---------------------------------------------------------------------------

constexpr int KJ = 2 * JB;  // senders per block of kernel K

__host__ __device__ inline size_t pair_fwd_smem(int H1, int H2) {
  return sizeof(float) * (gate_floats(KJ, H1, H2) + (size_t)KJ);
}

__global__ void __launch_bounds__(NT) qhnet_pair_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ zi, const float* __restrict__ maskf,
    const float* __restrict__ hr, const float* __restrict__ hs, const float* __restrict__ w2r,
    const float* __restrict__ b2r, const float* __restrict__ w2s, const float* __restrict__ b2s,
    float* __restrict__ out, int A, int C, int H1, int H2, int Kz, int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles = (A + KJ - 1) / KJ;
  const int bi = blockIdx.x / tiles, jlo = (blockIdx.x - bi * tiles) * KJ;
  const int nj = min(KJ, A - jlo), b = bi / A, tid = threadIdx.x, S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  const size_t row0 = (size_t)bi * A + jlo;  // pair (b, i, jlo)
  const GateRows gr = stage_gate_rows(hr, hs, row0 * H1, row0 * H2, H1, H2, nj, H1, H2, smem);
  float* mask_s = smem + gate_floats(KJ, H1, H2);
  for (int q = tid; q < KJ; q += NT) mask_s[q] = q < nj ? maskf[row0 + q] : 0.f;
  __syncthreads();
  const int PC = pt.n * C;
  const float* xb = x + (size_t)b * S * A * C;
  const float* zb = zi + (size_t)bi * Kz * C;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int r0 = 0; r0 < nj; r0 += JB) {
      for (int l3 = 0; l3 <= lmax; ++l3) {
        const int m3 = 2 * l3 + 1;
        float acc[JB][MX];
#pragma unroll
        for (int q = 0; q < JB; ++q)
#pragma unroll
          for (int m = 0; m < MX; ++m) acc[q][m] = 0.f;
        for (int e = pt.l3_start[l3]; e < pt.l3_start[l3 + 1]; ++e) {
          const int p = pt.by_l3[e], l2 = pt.l2[p], n2 = 2 * l2 + 1;
          const int col = p * C + cc;
          float ur[JB], us[JB], wq[JB];
          gate_block(gr, r0, H1, H2, w2r, b2r, w2s, b2s, col, PC, ur, us);
#pragma unroll
          for (int q = 0; q < JB; ++q) wq[q] = ur[q] * us[q] * mask_s[r0 + q];
          const float* zp = zb + (size_t)pt.zi_off[p] * C + cc;
#pragma unroll
          for (int bb = 0; bb < MX; ++bb) {
            if (bb >= n2) break;
            float xw[JB];
#pragma unroll
            for (int q = 0; q < JB; ++q) {
              const int j = jlo + r0 + q;
              xw[q] = r0 + q < nj ? xb[((size_t)(l2 * l2 + bb) * A + j) * C + cc] * wq[q] : 0.f;
            }
#pragma unroll
            for (int m = 0; m < MX; ++m) {
              if (m >= m3) break;
              const float z = __ldg(zp + (size_t)(bb * m3 + m) * C);
#pragma unroll
              for (int q = 0; q < JB; ++q) acc[q][m] = fmaf(z, xw[q], acc[q][m]);
            }
          }
        }
        if (act) {
#pragma unroll
          for (int q = 0; q < JB; ++q) {
            if (r0 + q >= nj) break;
            const int j = jlo + r0 + q;
#pragma unroll
            for (int m = 0; m < MX; ++m)
              if (m < m3) out[((((size_t)bi * S) + l3 * l3 + m) * A + j) * C + c] = acc[q][m];
          }
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel L, main stage: one block per (molecule b, receiver i); owns gzi[b,i] and
// writes gu_r, gu_s and the masked w of every pair (b, i, j). Per path and block of
// 8 senders: term[q][m] = sum_b zi[(b,m)] x[b][q] once, then gw and the cotangent
// gt = w g in the same registers, then gzi[(b,m)] += sum_q gt[q][m] x[b][q]
// ---------------------------------------------------------------------------

__host__ __device__ inline size_t pair_bwd_smem(int A, int H1, int H2) {
  return sizeof(float) * (gate_floats(A, H1, H2) + (size_t)round_up(A, JB) + (size_t)MXX * NT);
}

__global__ void __launch_bounds__(NT) qhnet_pair_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ zi, const float* __restrict__ maskf,
    const float* __restrict__ hr, const float* __restrict__ hs, const float* __restrict__ w2r,
    const float* __restrict__ b2r, const float* __restrict__ w2s, const float* __restrict__ b2s,
    const float* __restrict__ g, float* __restrict__ gzi, float* __restrict__ gu_r,
    float* __restrict__ gu_s, float* __restrict__ wm, int A, int C, int H1, int H2, int Kz,
    int lmax) {
  extern __shared__ float4 smem4[];
  __shared__ PathTable pt;
  float* smem = reinterpret_cast<float*>(smem4);
  const int bi = blockIdx.x, b = bi / A, tid = threadIdx.x, S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  const GateRows gr = stage_gate_rows(hr, hs, (size_t)bi * A * H1, (size_t)bi * A * H2, H1, H2,
                                      A, H1, H2, smem);
  float* mask_s = smem + gate_floats(A, H1, H2);
  float* gz_s = mask_s + round_up(A, JB);  // [MXX][NT], each thread its own column
  for (int j = tid; j < round_up(A, JB); j += NT) mask_s[j] = j < A ? maskf[(size_t)bi * A + j] : 0.f;
  __syncthreads();
  const int PC = pt.n * C;
  const float* xb = x + (size_t)b * S * A * C;
  const float* zb = zi + (size_t)bi * Kz * C;
  float* gzb = gzi + (size_t)bi * Kz * C;
  // rows of the zi layout no path uses (its padding) get zero cotangents
  for (int idx = tid; idx < (Kz - pt.zi_used) * C; idx += NT) gzb[(size_t)pt.zi_used * C + idx] = 0.f;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int p = 0; p < pt.n; ++p) {
      const int l2 = pt.l2[p], l3 = pt.l3[p], n2 = 2 * l2 + 1, m3 = 2 * l3 + 1;
      const int col = p * C + cc;
      const float* zp = zb + (size_t)pt.zi_off[p] * C + cc;
      for (int k = 0; k < n2 * m3; ++k) gz_s[k * NT + tid] = 0.f;
      for (int j0 = 0; j0 < A; j0 += JB) {
        float ur[JB], us[JB], wq[JB], gw[JB], t[JB][MX];
        gate_block(gr, j0, H1, H2, w2r, b2r, w2s, b2s, col, PC, ur, us);
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          wq[q] = ur[q] * us[q] * mask_s[j0 + q];
          gw[q] = 0.f;
#pragma unroll
          for (int m = 0; m < MX; ++m) t[q][m] = 0.f;
        }
        // term[q][m] = sum_b zi[(b,m)] x[l2^2+b][j0+q]
#pragma unroll
        for (int bb = 0; bb < MX; ++bb) {
          if (bb >= n2) break;
          float xq[JB];
#pragma unroll
          for (int q = 0; q < JB; ++q)
            xq[q] = j0 + q < A ? xb[((size_t)(l2 * l2 + bb) * A + j0 + q) * C + cc] : 0.f;
#pragma unroll
          for (int m = 0; m < MX; ++m) {
            if (m >= m3) break;
            const float z = __ldg(zp + (size_t)(bb * m3 + m) * C);
#pragma unroll
            for (int q = 0; q < JB; ++q) t[q][m] = fmaf(z, xq[q], t[q][m]);
          }
        }
        // gw[q] = sum_m term g; t becomes gt = w g
        const float* gj = g + ((((size_t)bi * S) + l3 * l3) * A + j0) * C + cc;
#pragma unroll
        for (int m = 0; m < MX; ++m) {
          if (m >= m3) break;
#pragma unroll
          for (int q = 0; q < JB; ++q) {
            const float gm = j0 + q < A ? gj[((size_t)m * A + q) * C] : 0.f;
            gw[q] = fmaf(t[q][m], gm, gw[q]);
            t[q][m] = wq[q] * gm;
          }
        }
        // gzi[(b,m)] += sum_q gt[q][m] x[l2^2+b][j0+q]
#pragma unroll
        for (int bb = 0; bb < MX; ++bb) {
          if (bb >= n2) break;
          float xq[JB];
#pragma unroll
          for (int q = 0; q < JB; ++q)
            xq[q] = j0 + q < A ? xb[((size_t)(l2 * l2 + bb) * A + j0 + q) * C + cc] : 0.f;
#pragma unroll
          for (int m = 0; m < MX; ++m) {
            if (m >= m3) break;
            float sum = 0.f;
#pragma unroll
            for (int q = 0; q < JB; ++q) sum = fmaf(t[q][m], xq[q], sum);
            gz_s[(bb * m3 + m) * NT + tid] += sum;
          }
        }
        if (act) {
#pragma unroll
          for (int q = 0; q < JB; ++q) {
            const int j = j0 + q;
            if (j >= A) break;
            const float mf = mask_s[j];
            const size_t at = ((size_t)bi * A + j) * PC + col;
            gu_r[at] = gw[q] * us[q] * mf;
            gu_s[at] = gw[q] * ur[q] * mf;
            wm[at] = wq[q];
          }
        }
      }
      if (act)
        for (int k = 0; k < n2 * m3; ++k)
          gzb[((size_t)pt.zi_off[p] + k) * C + c] = gz_s[k * NT + tid];
    }
  }
}

// ---------------------------------------------------------------------------
// kernel L, gx stage: one block per (molecule b, GX_JT senders); gx[b,s,j,c] =
// sum_i sum_p sum_m wm[b,i,j,pC+c] g[b,i,l3^2+m,j,c] zi[b,i,off_p+bb*m3+m,c], s = l2^2+bb.
// Paths run grouped by l2, so the sums of one l2's slots stay in registers; each
// zi load feeds GX_JT senders.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) qhnet_pair_gx_kernel(
    const float* __restrict__ zi, const float* __restrict__ g, const float* __restrict__ wm,
    float* __restrict__ gx, int A, int C, int Kz, int lmax) {
  __shared__ PathTable pt;
  const int tiles = (A + GX_JT - 1) / GX_JT;
  const int b = blockIdx.x / tiles, j0 = (blockIdx.x - b * tiles) * GX_JT, tid = threadIdx.x;
  const int S = (lmax + 1) * (lmax + 1);
  if (tid == 0) build_paths(pt, lmax);
  __syncthreads();
  const int PC = pt.n * C;

  for (int c0 = 0; c0 < C; c0 += NT) {
    const int c = c0 + tid;
    const bool act = c < C;
    const int cc = act ? c : 0;
    for (int l2 = 0; l2 <= lmax; ++l2) {
      const int n2 = 2 * l2 + 1;
      float acc[GX_JT][MX];
#pragma unroll
      for (int q = 0; q < GX_JT; ++q)
#pragma unroll
        for (int bb = 0; bb < MX; ++bb) acc[q][bb] = 0.f;
      for (int e = pt.l2_start[l2]; e < pt.l2_start[l2 + 1]; ++e) {
        const int p = pt.by_l2[e], l3 = pt.l3[p], m3 = 2 * l3 + 1;
        for (int i = 0; i < A; ++i) {
          const size_t bi = (size_t)b * A + i;
          float wq[GX_JT];
#pragma unroll
          for (int q = 0; q < GX_JT; ++q)
            wq[q] = j0 + q < A ? wm[(bi * A + j0 + q) * PC + p * C + cc] : 0.f;
          const float* zp = zi + (bi * Kz + pt.zi_off[p]) * C + cc;
          const float* gp = g + ((bi * S + l3 * l3) * A + j0) * C + cc;
#pragma unroll
          for (int m = 0; m < MX; ++m) {
            if (m >= m3) break;
            float wg[GX_JT];
#pragma unroll
            for (int q = 0; q < GX_JT; ++q)
              wg[q] = j0 + q < A ? wq[q] * gp[((size_t)m * A + q) * C] : 0.f;
#pragma unroll
            for (int bb = 0; bb < MX; ++bb) {
              if (bb >= n2) break;
              const float z = __ldg(zp + (size_t)(bb * m3 + m) * C);
#pragma unroll
              for (int q = 0; q < GX_JT; ++q) acc[q][bb] = fmaf(wg[q], z, acc[q][bb]);
            }
          }
        }
      }
      if (act) {
#pragma unroll
        for (int q = 0; q < GX_JT; ++q) {
          if (j0 + q >= A) break;
#pragma unroll
          for (int bb = 0; bb < MX; ++bb)
            if (bb < n2) gx[(((size_t)b * S + l2 * l2 + bb) * A + j0 + q) * C + c] = acc[q][bb];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// gh = gu @ W2^T: out[M,N] = a[M,K] b[N,K]^T, 64 rows x BN columns per block, each
// output summed over K in order by one thread
// ---------------------------------------------------------------------------

template <int BN>
__global__ void __launch_bounds__(256) qhnet_gemm_nt_kernel(const float* __restrict__ a,
                                                             const float* __restrict__ bm,
                                                             float* __restrict__ out, int M,
                                                             int N, int K) {
  constexpr int BM = 64, BK = 16, TC = BN / 4, TR = 256 / TC, RPT = BM / TR;
  __shared__ float a_s[BK][BM + 1];
  __shared__ float b_s[BK][BN + 1];
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN, tid = threadIdx.x;
  const int tr = tid / TC, tc = tid % TC;
  float acc[RPT][4];
#pragma unroll
  for (int r = 0; r < RPT; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += 256) {
      const int mm = idx / BK, kk = idx % BK;
      a_s[kk][mm] = (m0 + mm < M && k0 + kk < K) ? a[(size_t)(m0 + mm) * K + k0 + kk] : 0.f;
    }
    for (int idx = tid; idx < BN * BK; idx += 256) {
      const int nn = idx / BK, kk = idx % BK;
      b_s[kk][nn] = (n0 + nn < N && k0 + kk < K) ? bm[(size_t)(n0 + nn) * K + k0 + kk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = b_s[kk][tc + TC * q];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float av = a_s[kk][tr + TR * r];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av, bv[q], acc[r][q]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int m = m0 + tr + TR * r;
    if (m >= M) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tc + TC * q;
      if (n < N) out[(size_t)m * N + n] = acc[r][q];
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradients: part[b * GW_SPLITS + sp] ([K+1, N]) = sum over the pairs of slice
// sp of molecule b of x[p]^T y[p], row K the bias (x's implicit column of ones);
// x [B, A*A, K] (the gate hiddens), y [B, A*A, N] (gu). Each thread RH rows x 4 columns.
// ---------------------------------------------------------------------------

template <int RH>
__global__ void __launch_bounds__(256) qhnet_gw_kernel(const float* __restrict__ xm,
                                                       const float* __restrict__ ym,
                                                       float* __restrict__ part, int P, int K,
                                                       int N) {
  constexpr int RT = 16 * RH;
  __shared__ float x_s[GW_PT][RT];
  __shared__ float y_s[GW_PT][GW_NT];
  const int n0 = blockIdx.x * GW_NT, r0 = blockIdx.y * RT, z = blockIdx.z;
  const int b = z / GW_SPLITS, sp = z - b * GW_SPLITS;
  const int per = (P + GW_SPLITS - 1) / GW_SPLITS;
  const int p_lo = sp * per, p_hi = min(P, p_lo + per);
  const int tid = threadIdx.x, tr = tid / 16, tn = tid % 16;
  float acc[RH][4];
#pragma unroll
  for (int h = 0; h < RH; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[h][q] = 0.f;
  for (int p0 = p_lo; p0 < p_hi; p0 += GW_PT) {
    for (int idx = tid; idx < GW_PT * RT; idx += 256) {
      const int pp = idx / RT, rr = idx - pp * RT;
      const int p = p0 + pp, r = r0 + rr;
      const bool in = p < p_hi;
      x_s[pp][rr] = !in ? 0.f : (r < K ? xm[((size_t)b * P + p) * K + r] : (r == K ? 1.f : 0.f));
    }
    for (int idx = tid; idx < GW_PT * GW_NT; idx += 256) {
      const int pp = idx / GW_NT, nn = idx - pp * GW_NT;
      const int p = p0 + pp, n = n0 + nn;
      y_s[pp][nn] = (p < p_hi && n < N) ? ym[((size_t)b * P + p) * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < GW_PT; ++pp) {
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = y_s[pp][tn + 16 * q];
#pragma unroll
      for (int h = 0; h < RH; ++h) {
        const float xv = x_s[pp][tr + 16 * h];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(xv, y[q], acc[h][q]);
      }
    }
    __syncthreads();
  }
  float* o = part + (size_t)z * (K + 1) * N;
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    const int r = r0 + tr + 16 * h;
    if (r > K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tn + 16 * q;
      if (n < N) o[(size_t)r * N + n] = acc[h][q];
    }
  }
}

// out[idx] = sum over the nparts partials, in order: the same bits every run
__global__ void qhnet_gw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                       int nparts, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int z = 0; z < nparts; ++z) s += part[(size_t)z * n + idx];
  out[idx] = s;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int BN>
cudaError_t launch_gemm_nt(const float* a, const float* bm, float* out, int M, int N, int K,
                           cudaStream_t s) {
  const dim3 grid((M + 63) / 64, (N + BN - 1) / BN);
  qhnet_gemm_nt_kernel<BN><<<grid, 256, 0, s>>>(a, bm, out, M, N, K);
  return cudaGetLastError();
}

// gh [M, H] = gu [M, PC] @ W2 [H, PC]^T, the tile width fitted to H
cudaError_t gate_hidden_grad(const float* gu, const float* w2, float* gh, int M, int H, int PC,
                             cudaStream_t s) {
  if (H <= 16) return launch_gemm_nt<16>(gu, w2, gh, M, H, PC, s);
  if (H <= 32) return launch_gemm_nt<32>(gu, w2, gh, M, H, PC, s);
  return launch_gemm_nt<64>(gu, w2, gh, M, H, PC, s);
}

// [gW2; gb2] [H+1, PC] = sum over pairs of [h, 1]^T gu, by partials and a fixed-order sum
cudaError_t gate_weight_grad(const float* h, const float* gu, float* part, float* out, int B,
                             int P, int H, int PC, cudaStream_t s) {
  const int rt = H + 1 <= 16 ? 16 : 48;
  const dim3 grid((PC + GW_NT - 1) / GW_NT, (H + 1 + rt - 1) / rt, B * GW_SPLITS);
  if (rt == 16)
    qhnet_gw_kernel<1><<<grid, 256, 0, s>>>(h, gu, part, P, H, PC);
  else
    qhnet_gw_kernel<3><<<grid, 256, 0, s>>>(h, gu, part, P, H, PC);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (H + 1) * PC;
  qhnet_gw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, out, B * GW_SPLITS, n);
  return cudaGetLastError();
}

// both gates' hidden and weight cotangents from the per-pair gu_r, gu_s
cudaError_t gate_grads(const float* hr, const float* hs, const float* w2r, const float* w2s,
                       const float* gu_r, const float* gu_s, float* ghr, float* ghs,
                       float* gwb_r, float* gwb_s, float* part_r, float* part_s, int B, int A,
                       int H1, int H2, int PC, cudaStream_t s) {
  const int M = B * A * A;
  cudaError_t err = gate_hidden_grad(gu_r, w2r, ghr, M, H1, PC, s);
  if (err == cudaSuccess) err = gate_hidden_grad(gu_s, w2s, ghs, M, H2, PC, s);
  if (err == cudaSuccess) err = gate_weight_grad(hr, gu_r, part_r, gwb_r, B, A * A, H1, PC, s);
  if (err == cudaSuccess) err = gate_weight_grad(hs, gu_s, part_s, gwb_s, B, A * A, H2, PC, s);
  return err;
}

}  // namespace

extern "C" {

// Partials per molecule of the weight-gradient stage: the wrappers size the
// [B * splits, H + 1, PC] scratch by it.
int qhnet_gw_splits() { return GW_SPLITS; }

// Each returns a cudaError_t (0 = success), launches on `stream`, does not sync;
// cudaErrorInvalidValue for lmax above 4.
int qhnet_conv_fwd(const float* x, const float* cgsh, const float* hr, const float* hs,
                   const float* w2r, const float* b2r, const float* w2s, const float* b2s,
                   float* out, int B, int A, int C, int H1, int H2, int K, int lmax,
                   void* stream) {
  if (lmax < 0 || lmax > LMAXK) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  const size_t smem = conv_fwd_smem(A, H1, H2);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(qhnet_conv_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  qhnet_conv_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, cgsh, hr, hs, w2r, b2r, w2s, b2s, out, A, C, H1, H2, K, lmax);
  return (int)cudaGetLastError();
}

// gwb_r [H1+1, PC] (gW2r over gb2r), gwb_s [H2+1, PC]; scratch gu_r, gu_s [B,A,A,PC],
// part_r [B*splits, H1+1, PC], part_s [B*splits, H2+1, PC]
int qhnet_conv_bwd(const float* x, const float* cgsh, const float* hr, const float* hs,
                   const float* w2r, const float* b2r, const float* w2s, const float* b2s,
                   const float* g, float* gx, float* ghr, float* ghs, float* gwb_r, float* gwb_s,
                   float* gu_r, float* gu_s, float* part_r, float* part_s, int B, int A, int C,
                   int H1, int H2, int K, int lmax, void* stream) {
  if (lmax < 0 || lmax > LMAXK) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int S = (lmax + 1) * (lmax + 1), PC = n_paths(lmax) * C;
  const size_t smem = conv_bwd_smem(A, H1, H2, S);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(qhnet_conv_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  qhnet_conv_bwd_kernel<<<B * A, NT, smem, s>>>(x, cgsh, hr, hs, w2r, b2r, w2s, b2s, g, gx,
                                                gu_r, gu_s, A, C, H1, H2, K, lmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gate_grads(hr, hs, w2r, w2s, gu_r, gu_s, ghr, ghs, gwb_r, gwb_s, part_r, part_s,
                         B, A, H1, H2, PC, s);
}

int qhnet_pair_fwd(const float* x, const float* zi, const float* maskf, const float* hr,
                   const float* hs, const float* w2r, const float* b2r, const float* w2s,
                   const float* b2s, float* out, int B, int A, int C, int H1, int H2, int Kz,
                   int lmax, void* stream) {
  if (lmax < 0 || lmax > LMAXK) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  const size_t smem = pair_fwd_smem(H1, H2);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(qhnet_pair_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (A + KJ - 1) / KJ;
  qhnet_pair_fwd_kernel<<<B * A * tiles, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, out, A, C, H1, H2, Kz, lmax);
  return (int)cudaGetLastError();
}

// as qhnet_conv_bwd, plus gzi [B,A,Kz,C] and the scratch wm [B,A,A,PC] (masked w)
int qhnet_pair_bwd(const float* x, const float* zi, const float* maskf, const float* hr,
                   const float* hs, const float* w2r, const float* b2r, const float* w2s,
                   const float* b2s, const float* g, float* gx, float* gzi, float* ghr,
                   float* ghs, float* gwb_r, float* gwb_s, float* gu_r, float* gu_s, float* wm,
                   float* part_r, float* part_s, int B, int A, int C, int H1, int H2, int Kz,
                   int lmax, void* stream) {
  if (lmax < 0 || lmax > LMAXK) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int PC = n_paths(lmax) * C;
  const size_t smem = pair_bwd_smem(A, H1, H2);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(qhnet_pair_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  qhnet_pair_bwd_kernel<<<B * A, NT, smem, s>>>(x, zi, maskf, hr, hs, w2r, b2r, w2s, b2s, g,
                                                gzi, gu_r, gu_s, wm, A, C, H1, H2, Kz, lmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles = (A + GX_JT - 1) / GX_JT;
  qhnet_pair_gx_kernel<<<B * tiles, NT, 0, s>>>(zi, g, wm, gx, A, C, Kz, lmax);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gate_grads(hr, hs, w2r, w2s, gu_r, gu_s, ghr, ghs, gwb_r, gwb_s, part_r, part_s,
                         B, A, H1, H2, PC, s);
}

}  // extern "C"
