// Fused PaiNN message kernels for Hopper (sm_90a).
//
// Kernel A, painn_fwd_kernel, replaces nabladft_tpu/ops/pallas/painn_fused.py
// `_fwd_kernel` (launched by `_run_fwd`'s pallas_call):
//   wm   = rbf @ W                         W [R, 3F], three F-wide slices k
//   ds_i = sum_j wm0[i,j] * phi0_j
//   dv_ic = sum_j wm1[i,j] * phi1_j * v_jc + sum_j u_c(j->i) * wm2[i,j] * phi2_j
// Kernel B, painn_bwd, replaces `_bwd_kernel` (launched by `_run_bwd`'s pallas_call): the VJP
// of A, with the radial chain folded into g_dist through rbfp = d(basis*env)/d dist.
// Kernel C, painn_dual_fwd_kernel, replaces `_dual_fwd_kernel` (launched by
// `_run_dual_fwd`): A's primal lane plus its tangent lane along
// (rbfd, phid, vd, unitd_t), with wmd = rbfd @ W:
//   dsd_i  = sum_j wmd0 phi0_j + wm0 phid0_j
//   dvd_ic = sum_j (wmd1 phi1_j + wm1 phid1_j) v_jc + wm1 phi1_j vd_jc
//          + sum_j ud_c (wm2 phi2_j) + u_c (wmd2 phi2_j + wm2 phid2_j)
// Kernel D, painn_dual_bwd, replaces `_dual_bwd_kernel` (launched by `_run_dual_bwd`): the
// VJP of C for the node inputs and W only (no pair cotangents).
//
// Layouts (as the JAX op): rbf, rbfp [B,A,A,R]; phi, v, gdv, dv [B,A,3F] with
// v c-major (slice c*F:(c+1)*F is component c); unit_t [B,A,3,A] with
// unit_t[b,i,c,j] = unit(j->i)_c; ds, gds [B,A,F]; all float32, contiguous.
//
// A and C, fp32 FMA on the CUDA cores: the three [A,R]x[R,F] products per molecule row
// (six in C) make them compute bound on the fp32 FMA rate (at B=64, A=48, R=100, F=128
// kernel A does about 12 GFLOP against about 0.07 GB of traffic). They keep every [A,A,F]
// intermediate in registers and stage the pair rows in shared memory, so each rbf value is
// read from device memory once per block: one block per (molecule b, receiver i) stages
// rbf[b,i] ([A,R]) (and rbfd[b,i]) and unit_t[b,i]; each thread owns one channel f and a
// group of senders j, forms wm for JB senders at a time in registers (one W load feeds JB
// FMAs, rbf rows are read as float4 broadcasts) and folds them straight into its partial
// ds / dv sums. The sender groups are summed through shared memory at the end: no sum
// crosses blocks.
//
// B and D, the radial products on the tensor cores over the live pairs only. Their outputs
// are sums over receivers i for a fixed sender j (gphi, gv; D's gphid, gvd), sums over
// channels per pair (B's g_dist, g_unit_t) and gW, a sum over every pair. So:
//   * painn_flags_kernel marks slot (b, j, i) live when row rbf[b,i,j] or the second pair
//     tensor's row (rbfp in B, rbfd in D) is not zero (a dead pair adds exact zeros to every
//     output); so2_common.cuh's live_rows lists the live slots in that sender order with each
//     sender's first row, and its so2_pair_rows_kernel maps them to their pair rows (b, i, j)
//     for the gathers.
//   * wm = rbf W and the second product (rp = rbfp W, or wmd = rbfd W) run on
//     so2_common.cuh's engine (3xTF32 wgmma, fp32-accurate) over the gathered live rows into
//     compact [live, 3F] rows: K = R = 100 is four k tiles, so the launch runs persistent.
//   * A stage on the CUDA cores, one block per (b, sender j) and a thread per channel, walks
//     j's live receivers: it reads each pair's two product rows once, with the receiver's
//     cotangents, and sums the node cotangents in registers (no partials, no atomics). B's
//     per-pair channel sums (g_dist, g_unit_t) are reduced over each warp by a transposing
//     shuffle (4 receivers x 4 sums: 16 shuffles) and over the warps through shared memory;
//     only live slots are written (the caller's zeros stay in the dead ones). With gW asked
//     for, the stage overwrites the product rows in place by the per-pair cotangents gwm
//     (and D's gwmd).
//   * gW = rbf_live^T gwm (+ rbfd_live^T gwmd) is the engine's weight-gradient product over
//     the live rows, as fixed-order partials over a split of the rows sized from the shapes:
//     B and D give the same bits on every run.
// The engine takes K a multiple of 4 and 16-byte aligned rows: the entry points take R a
// multiple of 4 and W's rows padded to ld (>= 3F, a multiple of 4), which the wrapper
// provides (painn-oc's R = 100, 3F = 384 need no padding).

#include <cuda_runtime.h>

#include "so2_common.cuh"

namespace {

constexpr int NT = 256;       // threads per block (A and C)
constexpr int FT = 128;       // channel lanes per block
constexpr int GROUPS = NT / FT;  // row groups sharing a channel lane (2)
constexpr int JB = 8;         // rows per register block

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows padded so each of the GROUPS row groups holds whole JB blocks
__host__ __device__ inline int padded_rows(int a) { return round_up(a, JB * GROUPS); }

// acc[q] += sum_r rows[(row0+q)*Rp + r] * w[r*F3]   for q < JB (rows zero padded)
__device__ inline void row_block_dot(const float* __restrict__ rows, int row0, int Rp, int R,
                                     const float* __restrict__ wcol, int F3, float acc[JB]) {
  for (int r = 0; r < Rp; r += 4) {
    const float w0 = r < R ? __ldg(wcol + (size_t)r * F3) : 0.f;
    const float w1 = r + 1 < R ? __ldg(wcol + (size_t)(r + 1) * F3) : 0.f;
    const float w2 = r + 2 < R ? __ldg(wcol + (size_t)(r + 2) * F3) : 0.f;
    const float w3 = r + 3 < R ? __ldg(wcol + (size_t)(r + 3) * F3) : 0.f;
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(rows + (size_t)(row0 + q) * Rp + r);
      acc[q] = fmaf(x.x, w0, acc[q]);
      acc[q] = fmaf(x.y, w1, acc[q]);
      acc[q] = fmaf(x.z, w2, acc[q]);
      acc[q] = fmaf(x.w, w3, acc[q]);
    }
  }
}

// two row sets against one weight column (C: wm and wmd together)
__device__ inline void row_block_dot2(const float* __restrict__ rows, const float* __restrict__ rows2,
                                      int row0, int Rp, int R, const float* __restrict__ wcol, int F3,
                                      float acc[JB], float acc2[JB]) {
  for (int r = 0; r < Rp; r += 4) {
    const float w0 = r < R ? __ldg(wcol + (size_t)r * F3) : 0.f;
    const float w1 = r + 1 < R ? __ldg(wcol + (size_t)(r + 1) * F3) : 0.f;
    const float w2 = r + 2 < R ? __ldg(wcol + (size_t)(r + 2) * F3) : 0.f;
    const float w3 = r + 3 < R ? __ldg(wcol + (size_t)(r + 3) * F3) : 0.f;
#pragma unroll
    for (int q = 0; q < JB; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(rows + (size_t)(row0 + q) * Rp + r);
      acc[q] = fmaf(x.x, w0, acc[q]);
      acc[q] = fmaf(x.y, w1, acc[q]);
      acc[q] = fmaf(x.z, w2, acc[q]);
      acc[q] = fmaf(x.w, w3, acc[q]);
      const float4 y = *reinterpret_cast<const float4*>(rows2 + (size_t)(row0 + q) * Rp + r);
      acc2[q] = fmaf(y.x, w0, acc2[q]);
      acc2[q] = fmaf(y.y, w1, acc2[q]);
      acc2[q] = fmaf(y.z, w2, acc2[q]);
      acc2[q] = fmaf(y.w, w3, acc2[q]);
    }
  }
}

size_t fwd_smem_bytes(int A, int R) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4);
  return sizeof(float) * ((size_t)Ap * Rp + 3 * Ap + (GROUPS - 1) * 4 * FT);
}

// ---------------------------------------------------------------------------
// kernel A
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) painn_fwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ phi, const float* __restrict__ v,
    const float* __restrict__ ut, const float* __restrict__ w,
    float* __restrict__ ds, float* __restrict__ dv, int A, int R, int F) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Ap = padded_rows(A), Rp = round_up(R, 4), F3 = 3 * F;
  float* rbf_s = smem;             // [Ap][Rp]  rbf[b,i,j,:] by sender j
  float* u_s = rbf_s + Ap * Rp;    // [3][Ap]   unit_t[b,i,c,j]
  float* red = u_s + 3 * Ap;       // [GROUPS-1][4][FT]

  const int bi = blockIdx.x;       // b*A + i
  const int b = bi / A;
  const int tid = threadIdx.x;

  const float* rrow = rbf + (size_t)bi * A * R;
  for (int idx = tid; idx < Ap * Rp; idx += NT) {
    const int j = idx / Rp, r = idx - j * Rp;
    rbf_s[idx] = (j < A && r < R) ? rrow[(size_t)j * R + r] : 0.f;
  }
  const float* urow = ut + (size_t)bi * 3 * A;
  for (int idx = tid; idx < 3 * Ap; idx += NT) {
    const int c = idx / Ap, j = idx - c * Ap;
    u_s[idx] = j < A ? urow[c * A + j] : 0.f;
  }
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT;
  const int rows = Ap / GROUPS;
  const float* phib = phi + (size_t)b * A * F3;
  const float* vb = v + (size_t)b * A * F3;

  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    float s0 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;
    for (int k = 0; k < 3; ++k) {
      const float* wcol = w + k * F + (active ? f : 0);
      for (int j0 = grp * rows; j0 < (grp + 1) * rows; j0 += JB) {
        float acc[JB];
#pragma unroll
        for (int q = 0; q < JB; ++q) acc[q] = 0.f;
        row_block_dot(rbf_s, j0, Rp, R, wcol, F3, acc);
        if (!active) continue;
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int j = j0 + q;
          if (j >= A) continue;
          const float* pj = phib + (size_t)j * F3;
          if (k == 0) {
            s0 = fmaf(acc[q], pj[f], s0);
          } else if (k == 1) {
            const float t = acc[q] * pj[F + f];
            const float* vj = vb + (size_t)j * F3;
            d0 = fmaf(t, vj[f], d0);
            d1 = fmaf(t, vj[F + f], d1);
            d2 = fmaf(t, vj[2 * F + f], d2);
          } else {
            const float t = acc[q] * pj[2 * F + f];
            d0 = fmaf(u_s[j], t, d0);
            d1 = fmaf(u_s[Ap + j], t, d1);
            d2 = fmaf(u_s[2 * Ap + j], t, d2);
          }
        }
      }
    }
    if (grp > 0) {
      float* rg = red + (size_t)(grp - 1) * 4 * FT;
      rg[fl] = s0;
      rg[FT + fl] = d0;
      rg[2 * FT + fl] = d1;
      rg[3 * FT + fl] = d2;
    }
    __syncthreads();
    if (grp == 0 && active) {
      for (int g = 1; g < GROUPS; ++g) {
        const float* rg = red + (size_t)(g - 1) * 4 * FT;
        s0 += rg[fl];
        d0 += rg[FT + fl];
        d1 += rg[2 * FT + fl];
        d2 += rg[3 * FT + fl];
      }
      ds[(size_t)bi * F + f] = s0;
      float* dvo = dv + (size_t)bi * F3;
      dvo[f] = d0;
      dvo[F + f] = d1;
      dvo[2 * F + f] = d2;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// kernels B and D: the live pairs in sender order
// ---------------------------------------------------------------------------

constexpr int PF_WARPS = 8;  // the flags kernel: warps a block (receiver rows a warp at a time)

// flags[(b*A + j)*A + i] = 1 when row (b, i, j) of t or t2 [B*A*A, R] (R a multiple of 4) has
// a value that is not zero: one block per sender (b, j), a warp a receiver row at a time, 16
// bytes a lane
__global__ void __launch_bounds__(PF_WARPS * 32) painn_flags_kernel(
    const float* __restrict__ t, const float* __restrict__ t2, int* __restrict__ flags, int A,
    int R) {
  const int bj = blockIdx.x, b = bj / A, j = bj - b * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < A; i += PF_WARPS) {
    const long long p = ((long long)b * A + i) * A + j;
    const float4* x = reinterpret_cast<const float4*>(t + p * R);
    const float4* y = reinterpret_cast<const float4*>(t2 + p * R);
    bool nz = false;
    for (int k = lane; k < R / 4; k += 32) {
      const float4 a = __ldg(x + k), c = __ldg(y + k);
      nz |= a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f || c.x != 0.f || c.y != 0.f ||
            c.z != 0.f || c.w != 0.f;
    }
    const bool live = __any_sync(0xffffffffu, nz);
    if (lane == 0) flags[(long long)bj * A + i] = live ? 1 : 0;
  }
}

// the stages: a thread a channel, F rounded up to whole warps; SMAXT threads at most for the
// register budget of the model's widths, a second instance beyond (up to 1024 channels)
constexpr int SMAXT = 256;
constexpr int BQ = 4;  // B's stage: receivers a thread holds at once (x 4 pair sums = 16)
constexpr int DQ = 4;  // D's stage
// B's stage at SMAXT: 3 blocks of SMAXT threads an SM (<= 80 registers), the fastest of the
// layouts timed on an H100 (4 or 8 receivers a thread, with and without a register cap)
constexpr int B_STAGE_MIN_BLOCKS = 3;

// ---------------------------------------------------------------------------
// kernel B's stage: one block per (molecule b, sender j), over j's live receivers i (rows
// rs[bj] .. rs[bj+1] - 1 of the compact products wm = rbf W and rp = rbfp W, ld floats a
// row), BQ at a time. Per pair and channel f:
//   gwm = (gds_i phi0_j, phi1_j sum_c gdv_ci v_cj, pa phi2_j),  pa = sum_c u_c gdv_ci
//   g_dist = sum_f gwm . rp,   g_unit_t_c = sum_f wm2 phi2_j gdv_ci
// and over i: gphi0_j = sum gds_i wm0, s_c = sum gdv_ci wm1 (gphi1_j = sum_c s_c v_cj,
// gv_cj = s_c phi1_j), gphi2_j = sum pa wm2. With need_gw, gwm overwrites wm (each element
// read and written by one thread).
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT, MAXT == SMAXT ? B_STAGE_MIN_BLOCKS : 1)
    painn_bwd_stage_kernel(
    float* __restrict__ wm, const float* __restrict__ rp, const int* __restrict__ eidx,
    const int* __restrict__ rs, const float* __restrict__ phi, const float* __restrict__ v,
    const float* __restrict__ ut, const float* __restrict__ gds, const float* __restrict__ gdv,
    float* __restrict__ gdist, float* __restrict__ gut, float* __restrict__ gphi,
    float* __restrict__ gv, int need_gw, int A, int F, int ld) {
  extern __shared__ float stage_s[];
  float* u_s = stage_s;      // [3][A]: unit_t[b,i,c,j] of this sender
  float* red = u_s + 3 * A;  // [2][warps][32]: the warps' pair sums, double buffered
  const int bj = blockIdx.x, b = bj / A, j = bj - b * A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int F3 = 3 * F, f = tid;
  const bool act = f < F;
  for (int idx = tid; idx < 3 * A; idx += blockDim.x) {
    const int c = idx / A, i = idx - c * A;
    u_s[idx] = ut[(((size_t)b * A + i) * 3 + c) * A + j];
  }
  const int e_lo = rs[bj], e_hi = rs[bj + 1];
  const float* pj = phi + (size_t)bj * F3;
  const float* vj = v + (size_t)bj * F3;
  const float p0 = act ? pj[f] : 0.f, p1 = act ? pj[F + f] : 0.f, p2 = act ? pj[2 * F + f] : 0.f;
  const float v0 = act ? vj[f] : 0.f, v1 = act ? vj[F + f] : 0.f, v2 = act ? vj[2 * F + f] : 0.f;
  float a0 = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, a2 = 0.f;
  __syncthreads();

  for (int e0 = e_lo, it = 0; e0 < e_hi; e0 += BQ, ++it) {
    const int n = min(BQ, e_hi - e0);
    // every load of the BQ receivers first, so that their latencies overlap
    float w[BQ][3], r[BQ][3], g1[BQ], g2[BQ][3];
    int ii[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) {
      const bool ok = act && q < n;
      const int e = e0 + (q < n ? q : 0);
      ii[q] = eidx[e] % A;
      const size_t node = (size_t)b * A + ii[q];
      const float* wr = wm + (size_t)e * ld;
      const float* rr = rp + (size_t)e * ld;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[q][k] = ok ? wr[k * F + f] : 0.f;
        r[q][k] = ok ? rr[k * F + f] : 0.f;
        g2[q][k] = ok ? gdv[node * F3 + k * F + f] : 0.f;
      }
      g1[q] = ok ? gds[node * F + f] : 0.f;
    }
    float val[4 * BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) {
      const int i = ii[q];
      const float pa =
          fmaf(u_s[2 * A + i], g2[q][2], fmaf(u_s[A + i], g2[q][1], u_s[i] * g2[q][0]));
      const float gw0 = g1[q] * p0;
      const float gw1 = p1 * fmaf(g2[q][2], v2, fmaf(g2[q][1], v1, g2[q][0] * v0));
      const float gw2 = pa * p2;
      val[4 * q] = fmaf(gw2, r[q][2], fmaf(gw1, r[q][1], gw0 * r[q][0]));
      const float m3 = w[q][2] * p2;
      val[4 * q + 1] = m3 * g2[q][0];
      val[4 * q + 2] = m3 * g2[q][1];
      val[4 * q + 3] = m3 * g2[q][2];
      a0 = fmaf(g1[q], w[q][0], a0);
      s0 = fmaf(g2[q][0], w[q][1], s0);
      s1 = fmaf(g2[q][1], w[q][1], s1);
      s2 = fmaf(g2[q][2], w[q][1], s2);
      a2 = fmaf(pa, w[q][2], a2);
      if (need_gw && act && q < n) {
        float* wr = wm + (size_t)(e0 + q) * ld;
        wr[f] = gw0;
        wr[F + f] = gw1;
        wr[2 * F + f] = gw2;
      }
    }
    // the pair sums: each warp's by shuffles, then the warps' in order through shared memory
    const float sum = warp_sums<4 * BQ>(val, lane);
    float* rb = red + (size_t)(it & 1) * nw * 32;
    rb[warp * 32 + lane] = sum;
    __syncthreads();
    if (tid < 4 * n) {
      float s = 0.f;
      for (int g = 0; g < nw; ++g) s += rb[g * 32 + tid];
      const int t = tid & 3, i = eidx[e0 + (tid >> 2)] % A;
      if (t == 0)
        gdist[((size_t)b * A + i) * A + j] = s;
      else
        gut[(((size_t)b * A + i) * 3 + (t - 1)) * A + j] = s;
    }
  }
  if (!act) return;
  float* go = gphi + (size_t)bj * F3;
  go[f] = a0;
  go[F + f] = fmaf(s2, v2, fmaf(s1, v1, s0 * v0));
  go[2 * F + f] = a2;
  float* gvo = gv + (size_t)bj * F3;
  gvo[f] = s0 * p1;
  gvo[F + f] = s1 * p1;
  gvo[2 * F + f] = s2 * p1;
}

size_t stage_smem(int A, int threads, bool pair_sums) {
  return sizeof(float) * ((pair_sums ? 3 : 6) * (size_t)A + (pair_sums ? 2 * (size_t)threads : 0));
}

// ---------------------------------------------------------------------------
// kernel C: dual forward, one block per (molecule b, receiver i)
// ---------------------------------------------------------------------------

constexpr int C_ACC = 8;  // s0, sd0, d0..2, dd0..2

size_t dual_fwd_smem_bytes(int A, int R) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4);
  return sizeof(float) * (2 * (size_t)Ap * Rp + 6 * Ap + (GROUPS - 1) * C_ACC * FT);
}

__global__ void __launch_bounds__(NT) painn_dual_fwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfd, const float* __restrict__ phi,
    const float* __restrict__ phid, const float* __restrict__ v, const float* __restrict__ vd,
    const float* __restrict__ ut, const float* __restrict__ utd, const float* __restrict__ w,
    float* __restrict__ ds, float* __restrict__ dv, float* __restrict__ dsd,
    float* __restrict__ dvd, int A, int R, int F) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Ap = padded_rows(A), Rp = round_up(R, 4), F3 = 3 * F;
  float* rbf_s = smem;              // [Ap][Rp]  rbf[b,i,j,:] by sender j
  float* rbfd_s = rbf_s + Ap * Rp;  // [Ap][Rp]  rbfd[b,i,j,:]
  float* u_s = rbfd_s + Ap * Rp;    // [3][Ap]   unit_t[b,i,c,j]
  float* ud_s = u_s + 3 * Ap;       // [3][Ap]   unitd_t[b,i,c,j]
  float* red = ud_s + 3 * Ap;       // [GROUPS-1][C_ACC][FT]

  const int bi = blockIdx.x;        // b*A + i
  const int b = bi / A;
  const int tid = threadIdx.x;

  const float* rrow = rbf + (size_t)bi * A * R;
  const float* rdrow = rbfd + (size_t)bi * A * R;
  for (int idx = tid; idx < Ap * Rp; idx += NT) {
    const int j = idx / Rp, r = idx - j * Rp;
    const bool in = j < A && r < R;
    rbf_s[idx] = in ? rrow[(size_t)j * R + r] : 0.f;
    rbfd_s[idx] = in ? rdrow[(size_t)j * R + r] : 0.f;
  }
  const float* urow = ut + (size_t)bi * 3 * A;
  const float* udrow = utd + (size_t)bi * 3 * A;
  for (int idx = tid; idx < 3 * Ap; idx += NT) {
    const int c = idx / Ap, j = idx - c * Ap;
    u_s[idx] = j < A ? urow[c * A + j] : 0.f;
    ud_s[idx] = j < A ? udrow[c * A + j] : 0.f;
  }
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT;
  const int rows = Ap / GROUPS;
  const size_t nb = (size_t)b * A * F3;

  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    float acc[C_ACC];
#pragma unroll
    for (int t = 0; t < C_ACC; ++t) acc[t] = 0.f;
    float &s0 = acc[0], &sd0 = acc[1], &d0 = acc[2], &d1 = acc[3], &d2 = acc[4];
    float &dd0 = acc[5], &dd1 = acc[6], &dd2 = acc[7];
    for (int k = 0; k < 3; ++k) {
      const float* wcol = w + k * F + (active ? f : 0);
      for (int j0 = grp * rows; j0 < (grp + 1) * rows; j0 += JB) {
        float wm[JB], wmd[JB];
#pragma unroll
        for (int q = 0; q < JB; ++q) wm[q] = wmd[q] = 0.f;
        row_block_dot2(rbf_s, rbfd_s, j0, Rp, R, wcol, F3, wm, wmd);
        if (!active) continue;
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int j = j0 + q;
          if (j >= A) continue;
          const size_t nj = nb + (size_t)j * F3;
          const float p = phi[nj + k * F + f], pd = phid[nj + k * F + f];
          if (k == 0) {
            s0 = fmaf(wm[q], p, s0);
            sd0 = fmaf(wmd[q], p, fmaf(wm[q], pd, sd0));
          } else if (k == 1) {
            const float t = wm[q] * p, td = fmaf(wmd[q], p, wm[q] * pd);
            const float v0 = v[nj + f], v1 = v[nj + F + f], v2 = v[nj + 2 * F + f];
            d0 = fmaf(t, v0, d0);
            d1 = fmaf(t, v1, d1);
            d2 = fmaf(t, v2, d2);
            dd0 = fmaf(td, v0, fmaf(t, vd[nj + f], dd0));
            dd1 = fmaf(td, v1, fmaf(t, vd[nj + F + f], dd1));
            dd2 = fmaf(td, v2, fmaf(t, vd[nj + 2 * F + f], dd2));
          } else {
            const float m3 = wm[q] * p, m3d = fmaf(wmd[q], p, wm[q] * pd);
            const float u0 = u_s[j], u1 = u_s[Ap + j], u2 = u_s[2 * Ap + j];
            d0 = fmaf(u0, m3, d0);
            d1 = fmaf(u1, m3, d1);
            d2 = fmaf(u2, m3, d2);
            dd0 = fmaf(ud_s[j], m3, fmaf(u0, m3d, dd0));
            dd1 = fmaf(ud_s[Ap + j], m3, fmaf(u1, m3d, dd1));
            dd2 = fmaf(ud_s[2 * Ap + j], m3, fmaf(u2, m3d, dd2));
          }
        }
      }
    }
    if (grp > 0) {
      float* rg = red + (size_t)(grp - 1) * C_ACC * FT;
#pragma unroll
      for (int t = 0; t < C_ACC; ++t) rg[t * FT + fl] = acc[t];
    }
    __syncthreads();
    if (grp == 0 && active) {
      for (int g = 1; g < GROUPS; ++g) {
        const float* rg = red + (size_t)(g - 1) * C_ACC * FT;
#pragma unroll
        for (int t = 0; t < C_ACC; ++t) acc[t] += rg[t * FT + fl];
      }
      ds[(size_t)bi * F + f] = s0;
      dsd[(size_t)bi * F + f] = sd0;
      float* dvo = dv + (size_t)bi * F3;
      float* dvdo = dvd + (size_t)bi * F3;
      dvo[f] = d0;
      dvo[F + f] = d1;
      dvo[2 * F + f] = d2;
      dvdo[f] = dd0;
      dvdo[F + f] = dd1;
      dvdo[2 * F + f] = dd2;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// kernel D's stage: one block per (molecule b, sender j), over j's live receivers i (rows of
// the compact products wm = rbf W and wmd = rbfd W), DQ at a time. Over i, per channel f:
//   gphi0 = sum g1 wm0 + g1d wmd0,  gphid0 = sum g1d wm0
//   s_c = sum g2_c wm1 + h_c wmd1,  sd_c = sum h_c wm1            (channel 1)
//   gphi2 = sum pa wm2 + pb wmd2,   gphid2 = sum pb wm2            (channel 2)
// with g1, g1d = gds_i, gdsd_i; g2_c, h_c = gdv_ci, gdvd_ci; pa = sum_c u_c g2_c + ud_c h_c,
// pb = sum_c u_c h_c; then phi_j, v_j and their tangents enter once (the epilogue). With
// need_gw, the per-pair cotangents overwrite the rows: gwm over wm, gwmd over wmd.
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT) painn_dual_bwd_stage_kernel(
    float* __restrict__ wm, float* __restrict__ wmd, const int* __restrict__ eidx,
    const int* __restrict__ rs, const float* __restrict__ phi, const float* __restrict__ phid,
    const float* __restrict__ v, const float* __restrict__ vd, const float* __restrict__ ut,
    const float* __restrict__ utd, const float* __restrict__ gds, const float* __restrict__ gdv,
    const float* __restrict__ gdsd, const float* __restrict__ gdvd, float* __restrict__ gphi,
    float* __restrict__ gphid, float* __restrict__ gv, float* __restrict__ gvd, int need_gw,
    int A, int F, int ld) {
  extern __shared__ float stage_s[];
  float* u_s = stage_s;      // [3][A]: unit_t[b,i,c,j] of this sender
  float* ud_s = u_s + 3 * A;  // [3][A]: unitd_t[b,i,c,j]
  const int bj = blockIdx.x, b = bj / A, j = bj - b * A;
  const int tid = threadIdx.x, F3 = 3 * F, f = tid;
  const bool act = f < F;
  for (int idx = tid; idx < 3 * A; idx += blockDim.x) {
    const int c = idx / A, i = idx - c * A;
    const size_t src = (((size_t)b * A + i) * 3 + c) * A + j;
    u_s[idx] = ut[src];
    ud_s[idx] = utd[src];
  }
  __syncthreads();
  if (!act) return;
  const int e_lo = rs[bj], e_hi = rs[bj + 1];
  const size_t nj = (size_t)bj * F3;
  const float p0 = phi[nj + f], p1 = phi[nj + F + f], p2 = phi[nj + 2 * F + f];
  const float pd0 = phid[nj + f], pd1 = phid[nj + F + f], pd2 = phid[nj + 2 * F + f];
  const float v0 = v[nj + f], v1 = v[nj + F + f], v2 = v[nj + 2 * F + f];
  const float e0v = vd[nj + f], e1v = vd[nj + F + f], e2v = vd[nj + 2 * F + f];
  float a0 = 0.f, ad0 = 0.f, s0 = 0.f, s1 = 0.f, s2 = 0.f, sd0 = 0.f, sd1 = 0.f, sd2 = 0.f;
  float a2 = 0.f, ad2 = 0.f;

  for (int e0 = e_lo; e0 < e_hi; e0 += DQ) {
    const int n = min(DQ, e_hi - e0);
    // every load of the DQ receivers first, so that their latencies overlap
    float w[DQ][3], wd[DQ][3], g2[DQ][3], h[DQ][3], g1[DQ], g1d[DQ];
    int ii[DQ];
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0);
      ii[q] = eidx[e] % A;
      const size_t node = (size_t)b * A + ii[q];
      const float* wr = wm + (size_t)e * ld;
      const float* wdr = wmd + (size_t)e * ld;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[q][k] = ok ? wr[k * F + f] : 0.f;
        wd[q][k] = ok ? wdr[k * F + f] : 0.f;
        g2[q][k] = ok ? gdv[node * F3 + k * F + f] : 0.f;
        h[q][k] = ok ? gdvd[node * F3 + k * F + f] : 0.f;
      }
      g1[q] = ok ? gds[node * F + f] : 0.f;
      g1d[q] = ok ? gdsd[node * F + f] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int i = ii[q];
      const float u0 = u_s[i], u1 = u_s[A + i], u2 = u_s[2 * A + i];
      const float pa =
          fmaf(ud_s[2 * A + i], h[q][2], fmaf(ud_s[A + i], h[q][1], fmaf(ud_s[i], h[q][0],
          fmaf(u2, g2[q][2], fmaf(u1, g2[q][1], u0 * g2[q][0])))));
      const float pb = fmaf(u2, h[q][2], fmaf(u1, h[q][1], u0 * h[q][0]));
      a0 = fmaf(g1[q], w[q][0], fmaf(g1d[q], wd[q][0], a0));
      ad0 = fmaf(g1d[q], w[q][0], ad0);
      s0 = fmaf(g2[q][0], w[q][1], fmaf(h[q][0], wd[q][1], s0));
      s1 = fmaf(g2[q][1], w[q][1], fmaf(h[q][1], wd[q][1], s1));
      s2 = fmaf(g2[q][2], w[q][1], fmaf(h[q][2], wd[q][1], s2));
      sd0 = fmaf(h[q][0], w[q][1], sd0);
      sd1 = fmaf(h[q][1], w[q][1], sd1);
      sd2 = fmaf(h[q][2], w[q][1], sd2);
      a2 = fmaf(pa, w[q][2], fmaf(pb, wd[q][2], a2));
      ad2 = fmaf(pb, w[q][2], ad2);
      if (need_gw && q < n) {
        // gwm1 = phi1 t1 + phid1 t2, gwmd1 = phi1 t2 with t1 = sum_c g2_c v_c + h_c vd_c and
        // t2 = sum_c h_c v_c
        const float t1 = fmaf(h[q][2], e2v, fmaf(h[q][1], e1v, fmaf(h[q][0], e0v,
                         fmaf(g2[q][2], v2, fmaf(g2[q][1], v1, g2[q][0] * v0)))));
        const float t2 = fmaf(h[q][2], v2, fmaf(h[q][1], v1, h[q][0] * v0));
        float* wr = wm + (size_t)(e0 + q) * ld;
        float* wdr = wmd + (size_t)(e0 + q) * ld;
        wr[f] = fmaf(g1[q], p0, g1d[q] * pd0);
        wr[F + f] = fmaf(p1, t1, pd1 * t2);
        wr[2 * F + f] = fmaf(pa, p2, pb * pd2);
        wdr[f] = g1d[q] * p0;
        wdr[F + f] = p1 * t2;
        wdr[2 * F + f] = pb * p2;
      }
    }
  }
  gphi[nj + f] = a0;
  gphi[nj + F + f] = fmaf(sd2, e2v, fmaf(sd1, e1v, fmaf(sd0, e0v,
                     fmaf(s2, v2, fmaf(s1, v1, s0 * v0)))));
  gphi[nj + 2 * F + f] = a2;
  gphid[nj + f] = ad0;
  gphid[nj + F + f] = fmaf(sd2, v2, fmaf(sd1, v1, sd0 * v0));
  gphid[nj + 2 * F + f] = ad2;
  gv[nj + f] = fmaf(sd0, pd1, s0 * p1);
  gv[nj + F + f] = fmaf(sd1, pd1, s1 * p1);
  gv[nj + 2 * F + f] = fmaf(sd2, pd1, s2 * p1);
  gvd[nj + f] = sd0 * p1;
  gvd[nj + F + f] = sd1 * p1;
  gvd[nj + 2 * F + f] = sd2 * p1;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// B and D on the host: the live pairs, the radial products and gW on the engine
// ---------------------------------------------------------------------------

// what a call carves from its scratch
struct Work {
  float *x1, *x2;  // the products' compact rows [rows, ld]: wm and rp (B) or wmd (D)
  int *flags, *eidx, *pos, *row, *rs, *n_rows;
  Engine en;
};

long long pair_rows(int B, int A) { return (long long)B * A * A; }

// the weight-gradient partials of gW [R, ld] over `rows` row slots (the split is sized from
// the shapes only, so each bucket gives the same bits every run)
long long gw_part_floats(long long rows, int R, int ld) {
  return wgrad_part_floats(rows, {tprob({TSeg{}}, A_GATHER, R, ld, nullptr, ld)});
}

long long scratch_floats(int B, int A, int R, int ld) {
  const long long rows = pair_rows(B, A);
  return 2 * rows * ld + 2LL * ld * R + gw_part_floats(rows, R, ld);
}

long long scratch_ints(int B, int A) { return 4 * pair_rows(B, A) + (long long)B * A + 2; }

Work carve(int B, int A, int R, int ld, float* f, int* iw) {
  const long long rows = pair_rows(B, A), prep_n = 2LL * ld * R;
  Work w{};
  w.x1 = f;
  w.x2 = f + rows * ld;
  float* prep = f + 2 * rows * ld;
  w.flags = iw;
  w.eidx = iw + rows;
  w.pos = iw + 2 * rows;
  w.row = iw + 3 * rows;
  w.rs = iw + 4 * rows;
  w.n_rows = w.rs + (long long)B * A + 1;
  // the engine gathers the pair rows (b, i, j) of the live slots, listed in sender order
  w.en = Engine{rows, w.n_rows, w.row, prep, prep_n, prep + prep_n, gw_part_floats(rows, R, ld)};
  return w;
}

// the live slots (b, j, i) of rows of rbf or t2 that are not zero, in sender order (the
// engine's live_rows over segments of A slots), each sender's first row and the pair rows
cudaError_t live_pairs(const Work& w, const float* rbf, const float* t2, int B, int A, int R,
                       cudaStream_t st) {
  const long long rows = pair_rows(B, A);
  painn_flags_kernel<<<B * A, PF_WARPS * 32, 0, st>>>(rbf, t2, w.flags, A, R);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = live_rows(w.flags, w.eidx, w.pos, w.rs, w.n_rows, rows, A, st);
  if (err != cudaSuccess) return err;
  so2_pair_rows_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(w.eidx, w.n_rows, w.row,
                                                                      A);
  return cudaGetLastError();
}

// x1 = a1 W and x2 = a2 W over the live rows (gathered), into their compact rows; K = R is a
// few k tiles, so the launch runs persistent
cudaError_t radial_products(const Work& w, const float* a1, const float* a2, const float* wt,
                            int R, int ld, cudaStream_t st) {
  NNProb p1 = prob({seg(a1, R, wt, ld, R)}, ld, EPI_STORE, w.x1, ld);
  NNProb p2 = prob({seg(a2, R, wt, ld, R)}, ld, EPI_STORE, w.x2, ld);
  p1.gather = p2.gather = 1;
  return launch_products(w.en, {p1, p2}, st, true);
}

// gW [R, ld] = a1_live^T x1 (+ a2_live^T x2 where a2 is given)
cudaError_t weight_grad(const Work& w, const float* a1, const float* a2, float* gw, int R, int ld,
                        cudaStream_t st) {
  const TSeg s1{a1, w.x1, R, ld, 1.f}, s2{a2, w.x2, R, ld, 1.f};
  return launch_wgrads(w.en, {a2 ? tprob({s1, s2}, A_GATHER, R, ld, gw, ld)
                                 : tprob({s1}, A_GATHER, R, ld, gw, ld)}, st);
}

bool shapes_ok(int B, int A, int R, int F, int ld) {
  return R > 0 && R % 4 == 0 && F > 0 && F <= 1024 && ld >= 3 * F && ld % 4 == 0 &&
         pair_rows(B, A) < (1LL << 31);
}

}  // namespace

extern "C" {

// Returns a cudaError_t (0 = success). Launches on `stream`, does not sync.
int painn_fwd(const float* rbf, const float* phi, const float* v, const float* unit_t,
              const float* w, float* ds, float* dv, int B, int A, int R, int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  const size_t smem = fwd_smem_bytes(A, R);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(painn_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  painn_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rbf, phi, v, unit_t, w, ds, dv, A, R, F);
  return (int)cudaGetLastError();
}

// float and int scratch of a B or D call (painn_bwd, painn_dual_bwd) on B molecules of A atoms
// with R radial values and W rows of ld floats
long long painn_bwd_scratch_floats(int B, int A, int R, int ld) {
  return scratch_floats(B, A, R, ld);
}

long long painn_bwd_scratch_ints(int B, int A) { return scratch_ints(B, A); }

// Kernels B and D take R a multiple of 4, F <= 1024, W [R, ld] with ld >= 3F a multiple of 4
// and 16-byte aligned pair tensors (else cudaErrorInvalidValue); scratch and iscratch as
// painn_bwd_scratch_floats / _ints size them; gw [R, ld] is written only when need_gw != 0.
// Kernel B: gdist [B,A,A] and gut [B,A,3,A] must hold zeros (only live pairs are written).
int painn_bwd(const float* rbf, const float* rbfp, const float* phi, const float* v,
              const float* unit_t, const float* w, const float* gds, const float* gdv,
              float* gdist, float* gut, float* gphi, float* gv, float* gw, float* scratch,
              int* iscratch, int need_gw, int B, int A, int R, int F, int ld, void* stream) {
  if (!shapes_ok(B, A, R, F, ld) || !aligned16(rbf) || !aligned16(rbfp))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(B, A, R, ld, scratch, iscratch);
  cudaError_t err = live_pairs(wk, rbf, rbfp, B, A, R, st);
  if (err == cudaSuccess) err = radial_products(wk, rbf, rbfp, w, R, ld, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = round_up(F, 32);
  const size_t smem = stage_smem(A, threads, true);
  auto stage = [&](auto kernel) {
    cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return e;
    kernel<<<B * A, threads, smem, st>>>(wk.x1, wk.x2, wk.eidx, wk.rs, phi, v, unit_t, gds, gdv,
                                         gdist, gut, gphi, gv, need_gw, A, F, ld);
    return cudaGetLastError();
  };
  err = threads <= SMAXT ? stage(painn_bwd_stage_kernel<SMAXT>)
                         : stage(painn_bwd_stage_kernel<1024>);
  if (err != cudaSuccess || !need_gw) return (int)err;
  return (int)weight_grad(wk, rbf, nullptr, gw, R, ld, st);
}

int painn_dual_fwd(const float* rbf, const float* rbfd, const float* phi, const float* phid,
                   const float* v, const float* vd, const float* unit_t, const float* unitd_t,
                   const float* w, float* ds, float* dv, float* dsd, float* dvd,
                   int B, int A, int R, int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  const size_t smem = dual_fwd_smem_bytes(A, R);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(painn_dual_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  painn_dual_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w, ds, dv, dsd, dvd, A, R, F);
  return (int)cudaGetLastError();
}

// Kernel D: as painn_bwd (its live pairs are those of rbf or rbfd).
int painn_dual_bwd(const float* rbf, const float* rbfd, const float* phi, const float* phid,
                   const float* v, const float* vd, const float* unit_t, const float* unitd_t,
                   const float* w, const float* gds, const float* gdv, const float* gdsd,
                   const float* gdvd, float* gphi, float* gphid, float* gv, float* gvd,
                   float* gw, float* scratch, int* iscratch, int need_gw, int B, int A, int R,
                   int F, int ld, void* stream) {
  if (!shapes_ok(B, A, R, F, ld) || !aligned16(rbf) || !aligned16(rbfd))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(B, A, R, ld, scratch, iscratch);
  cudaError_t err = live_pairs(wk, rbf, rbfd, B, A, R, st);
  if (err == cudaSuccess) err = radial_products(wk, rbf, rbfd, w, R, ld, st);
  if (err != cudaSuccess) return (int)err;
  const int threads = round_up(F, 32);
  const size_t smem = stage_smem(A, threads, false);
  auto stage = [&](auto kernel) {
    cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return e;
    kernel<<<B * A, threads, smem, st>>>(wk.x1, wk.x2, wk.eidx, wk.rs, phi, phid, v, vd, unit_t,
                                         unitd_t, gds, gdv, gdsd, gdvd, gphi, gphid, gv, gvd,
                                         need_gw, A, F, ld);
    return cudaGetLastError();
  };
  err = threads <= SMAXT ? stage(painn_dual_bwd_stage_kernel<SMAXT>)
                         : stage(painn_dual_bwd_stage_kernel<1024>);
  if (err != cudaSuccess || !need_gw) return (int)err;
  return (int)weight_grad(wk, rbf, rbfd, gw, R, ld, st);
}

}  // extern "C"
