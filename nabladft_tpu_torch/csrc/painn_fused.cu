// Fused PaiNN message kernels for Hopper (sm_90a).
//
// Kernel A, painn_fwd, replaces nabladft_tpu/ops/pallas/painn_fused.py `_fwd_kernel`
// (launched by `_run_fwd`'s pallas_call):
//   wm   = rbf @ W                         W [R, 3F], three F-wide slices k
//   ds_i = sum_j wm0[i,j] * phi0_j
//   dv_ic = sum_j wm1[i,j] * phi1_j * v_jc + sum_j u_c(j->i) * wm2[i,j] * phi2_j
// Kernel B, painn_bwd, replaces `_bwd_kernel` (launched by `_run_bwd`'s pallas_call): the VJP
// of A, with the radial chain folded into g_dist through rbfp = d(basis*env)/d dist.
// Kernel C, painn_dual_fwd, replaces `_dual_fwd_kernel` (launched by `_run_dual_fwd`): A's
// primal lane plus its tangent lane along (rbfd, phid, vd, unitd_t), with wmd = rbfd @ W:
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
// Every kernel runs its radial products (R-long rows times W, about 6R of A's 6R + 16 FLOPs a
// channel and pair) on the tensor cores over the live pairs only: a dead pair (rbf row zero,
// and the second pair tensor's row zero where there is one) adds exact zeros to every output.
// The products are so2_common.cuh's engine (3xTF32 wgmma, fp32-accurate) over the gathered
// live rows into compact [live, ld] rows: K = R = 100 is four k tiles, so the launch runs
// persistent. What is left runs on the CUDA cores in a stage that sums in registers in a
// fixed order (no partials, no atomics): the same bits on every run. The work is bound by
// operations (at B=64, A=48, R=100, F=128 kernel A does about 8 GFLOP over the live pairs
// against about 0.08 GB of inputs and outputs).
//
// A and C, whose outputs are sums over senders j for a fixed receiver i (ds, dv; C's dsd,
// dvd), list the live pairs in receiver order:
//   * painn_flags_kernel<false> marks pair row (b, i, j) live when rbf[b,i,j] (C: or
//     rbfd[b,i,j]) is not zero; rbfd = rbfp * (a distance tangent) is not confined to rbf's
//     live pairs, and a pair live through rbfd alone still adds its wmd terms. live_rows
//     over segments of A rows (a receiver's) lists the live pair rows with each receiver's
//     first row: the list is the engine's gather list as it stands.
//   * wm = rbf W (C: and wmd = rbfd W, a second problem of the same launch).
//   * A stage, one block per (b, receiver i) and a thread per channel, walks i's live senders
//     in list order: it reads each pair's product rows once, the sender's node rows (phi, v;
//     C: phid, vd) through L2 and unit_t[b,i,:,j] (C: unitd_t) from shared memory. It writes
//     every receiver's row, zeros where the list is empty (padding, isolated atoms, an
//     all-dead batch), so the outputs need no fill.
//
// B and D, whose outputs are sums over receivers i for a fixed sender j (gphi, gv; D's gphid,
// gvd), sums over channels per pair (B's g_dist, g_unit_t) and gW, a sum over every pair,
// list the live pairs in sender order:
//   * painn_flags_kernel<true> marks slot (b, j, i) live when row rbf[b,i,j] or the second
//     pair tensor's row (rbfp in B, rbfd in D) is not zero; live_rows lists the live slots in
//     that sender order with each sender's first row, and so2_pair_rows_kernel maps them to
//     their pair rows (b, i, j) for the gathers.
//   * wm = rbf W and the second product (rp = rbfp W, or wmd = rbfd W) in one launch.
//   * A stage, one block per (b, sender j) and a thread per channel, walks j's live
//     receivers: it reads each pair's two product rows once, with the receiver's
//     cotangents, and sums the node cotangents in registers. B's per-pair channel sums
//     (g_dist, g_unit_t) are reduced over each warp by a transposing shuffle (4 receivers x
//     4 sums: 16 shuffles) and over the warps through shared memory; only live slots are
//     written (the caller's zeros stay in the dead ones). With gW asked for, the stage
//     overwrites the product rows in place by the per-pair cotangents gwm (and D's gwmd).
//   * gW = rbf_live^T gwm (+ rbfd_live^T gwmd) is the engine's weight-gradient product over
//     the live rows, as fixed-order partials over a split of the rows sized from the shapes.
// The engine takes K a multiple of 4 and 16-byte aligned rows: the entry points take R a
// multiple of 4 and W's rows padded to ld (>= 3F, a multiple of 4), which the wrapper
// provides (painn-oc's R = 100, 3F = 384 need no padding).

#include <cuda_runtime.h>

#include "so2_common.cuh"

namespace {

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// ---------------------------------------------------------------------------
// the live pairs: flags in receiver order (A, C) or sender order (B, D)
// ---------------------------------------------------------------------------

constexpr int PF_WARPS = 8;  // the flags kernel: warps a block (pair rows a warp at a time)

// flags[s*A + k] = 1 when pair row p of t, or of t2 where given, [B*A*A, R] (R a multiple of
// 4) has a value that is not zero, for segment s = (b, o) and k < A. BY_SENDER: o is the
// sender j and k the receiver i, p = (b*A + i)*A + j (B's and D's slots); else o is the
// receiver i and k the sender j, p = s*A + k (A's and C's slots are the pair rows). One block
// a segment, a warp a pair row at a time, 16 bytes a lane.
template <bool BY_SENDER>
__global__ void __launch_bounds__(PF_WARPS * 32) painn_flags_kernel(
    const float* __restrict__ t, const float* __restrict__ t2, int* __restrict__ flags, int A,
    int R) {
  const int s = blockIdx.x, b = s / A, o = s - b * A;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = warp; k < A; k += PF_WARPS) {
    const long long p = BY_SENDER ? ((long long)b * A + k) * A + o : (long long)s * A + k;
    const float4* x = reinterpret_cast<const float4*>(t + p * R);
    const float4* y = t2 ? reinterpret_cast<const float4*>(t2 + p * R) : nullptr;
    bool nz = false;
    for (int q = lane; q < R / 4; q += 32) {
      const float4 a = __ldg(x + q), c = y ? __ldg(y + q) : zero;
      nz |= a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f || c.x != 0.f || c.y != 0.f ||
            c.z != 0.f || c.w != 0.f;
    }
    const bool live = __any_sync(0xffffffffu, nz);
    if (lane == 0) flags[(long long)s * A + k] = live ? 1 : 0;
  }
}

// the stages: a thread a channel, F rounded up to whole warps; SMAXT threads at most for the
// register budget of the model's widths, a second instance beyond (up to 1024 channels)
constexpr int SMAXT = 256;
constexpr int BQ = 4;  // B's stage: receivers a thread holds at once (x 4 pair sums = 16)
constexpr int DQ = 4;  // D's stage
constexpr int AQ = 4;  // A's and C's stages: senders a thread holds at once
// B's stage at SMAXT: 3 blocks of SMAXT threads an SM (<= 80 registers), the fastest of the
// layouts timed on an H100 (4 or 8 receivers a thread, with and without a register cap)
constexpr int B_STAGE_MIN_BLOCKS = 3;

// ---------------------------------------------------------------------------
// kernel A's stage: one block per (molecule b, receiver i), over i's live senders j (rows
// rs[bi] .. rs[bi+1] - 1 of the compact product wm = rbf W, ld floats a row; eidx[e] the
// pair row (b*A + i)*A + j), AQ at a time. Per channel f, in list order:
//   ds_i  = sum_j wm0 phi0_j
//   dv_ic = sum_j wm1 phi1_j v_jc + u_c wm2 phi2_j
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT) painn_fwd_stage_kernel(
    const float* __restrict__ wm, const int* __restrict__ eidx, const int* __restrict__ rs,
    const float* __restrict__ phi, const float* __restrict__ v, const float* __restrict__ ut,
    float* __restrict__ ds, float* __restrict__ dv, int A, int F, int ld) {
  extern __shared__ float stage_s[];
  float* u_s = stage_s;  // [3][A]: unit_t[b,i,c,j] of this receiver
  const int bi = blockIdx.x, b = bi / A;
  const int tid = threadIdx.x, F3 = 3 * F, f = tid;
  for (int idx = tid; idx < 3 * A; idx += blockDim.x) u_s[idx] = ut[(size_t)bi * 3 * A + idx];
  __syncthreads();
  if (f >= F) return;
  const int e_lo = rs[bi], e_hi = rs[bi + 1], row0 = bi * A;  // eidx[e] - row0 = sender j
  const float* phib = phi + (size_t)b * A * F3 + f;
  const float* vb = v + (size_t)b * A * F3 + f;
  float s0 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f;

  for (int e0 = e_lo; e0 < e_hi; e0 += AQ) {
    const int n = min(AQ, e_hi - e0);
    // every load of the AQ senders first, so that their latencies overlap
    float w[AQ][3], p[AQ][3], x[AQ][3];
    int jj[AQ];
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0);
      jj[q] = eidx[e] - row0;
      const float* wr = wm + (size_t)e * ld + f;
      const float* pj = phib + (size_t)jj[q] * F3;
      const float* vj = vb + (size_t)jj[q] * F3;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[q][k] = ok ? wr[k * F] : 0.f;
        p[q][k] = ok ? pj[k * F] : 0.f;
        x[q][k] = ok ? vj[k * F] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int j = jj[q];
      const float t = w[q][1] * p[q][1], m3 = w[q][2] * p[q][2];
      s0 = fmaf(w[q][0], p[q][0], s0);
      d0 = fmaf(u_s[j], m3, fmaf(t, x[q][0], d0));
      d1 = fmaf(u_s[A + j], m3, fmaf(t, x[q][1], d1));
      d2 = fmaf(u_s[2 * A + j], m3, fmaf(t, x[q][2], d2));
    }
  }
  ds[(size_t)bi * F + f] = s0;
  float* dvo = dv + (size_t)bi * F3 + f;
  dvo[0] = d0;
  dvo[F] = d1;
  dvo[2 * F] = d2;
}

// ---------------------------------------------------------------------------
// kernel C's stage: as A's, over i's live senders j (rows of the compact products wm = rbf W
// and wmd = rbfd W), with the tangent lanes. Per channel f, in list order:
//   ds  = sum wm0 phi0_j,           dsd  = sum wmd0 phi0_j + wm0 phid0_j
//   t   = wm1 phi1_j,               td   = wmd1 phi1_j + wm1 phid1_j
//   m3  = wm2 phi2_j,               m3d  = wmd2 phi2_j + wm2 phid2_j
//   dv_c = sum t v_cj + u_c m3,     dvd_c = sum td v_cj + t vd_cj + ud_c m3 + u_c m3d
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT) painn_dual_fwd_stage_kernel(
    const float* __restrict__ wm, const float* __restrict__ wmd, const int* __restrict__ eidx,
    const int* __restrict__ rs, const float* __restrict__ phi, const float* __restrict__ phid,
    const float* __restrict__ v, const float* __restrict__ vd, const float* __restrict__ ut,
    const float* __restrict__ utd, float* __restrict__ ds, float* __restrict__ dv,
    float* __restrict__ dsd, float* __restrict__ dvd, int A, int F, int ld) {
  extern __shared__ float stage_s[];
  float* u_s = stage_s;       // [3][A]: unit_t[b,i,c,j] of this receiver
  float* ud_s = u_s + 3 * A;  // [3][A]: unitd_t[b,i,c,j]
  const int bi = blockIdx.x, b = bi / A;
  const int tid = threadIdx.x, F3 = 3 * F, f = tid;
  for (int idx = tid; idx < 3 * A; idx += blockDim.x) {
    u_s[idx] = ut[(size_t)bi * 3 * A + idx];
    ud_s[idx] = utd[(size_t)bi * 3 * A + idx];
  }
  __syncthreads();
  if (f >= F) return;
  const int e_lo = rs[bi], e_hi = rs[bi + 1], row0 = bi * A;
  const size_t nb = (size_t)b * A * F3 + f;
  float s0 = 0.f, sd0 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f, dd0 = 0.f, dd1 = 0.f, dd2 = 0.f;

  for (int e0 = e_lo; e0 < e_hi; e0 += AQ) {
    const int n = min(AQ, e_hi - e0);
    float w[AQ][3], wd[AQ][3], p[AQ][3], pd[AQ][3], x[AQ][3], xd[AQ][3];
    int jj[AQ];
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0);
      jj[q] = eidx[e] - row0;
      const size_t nj = nb + (size_t)jj[q] * F3;
      const float* wr = wm + (size_t)e * ld + f;
      const float* wdr = wmd + (size_t)e * ld + f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[q][k] = ok ? wr[k * F] : 0.f;
        wd[q][k] = ok ? wdr[k * F] : 0.f;
        p[q][k] = ok ? phi[nj + k * F] : 0.f;
        pd[q][k] = ok ? phid[nj + k * F] : 0.f;
        x[q][k] = ok ? v[nj + k * F] : 0.f;
        xd[q][k] = ok ? vd[nj + k * F] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < AQ; ++q) {
      const int j = jj[q];
      const float u0 = u_s[j], u1 = u_s[A + j], u2 = u_s[2 * A + j];
      const float t = w[q][1] * p[q][1], td = fmaf(wd[q][1], p[q][1], w[q][1] * pd[q][1]);
      const float m3 = w[q][2] * p[q][2], m3d = fmaf(wd[q][2], p[q][2], w[q][2] * pd[q][2]);
      s0 = fmaf(w[q][0], p[q][0], s0);
      sd0 = fmaf(wd[q][0], p[q][0], fmaf(w[q][0], pd[q][0], sd0));
      d0 = fmaf(u0, m3, fmaf(t, x[q][0], d0));
      d1 = fmaf(u1, m3, fmaf(t, x[q][1], d1));
      d2 = fmaf(u2, m3, fmaf(t, x[q][2], d2));
      dd0 = fmaf(ud_s[j], m3, fmaf(u0, m3d, fmaf(td, x[q][0], fmaf(t, xd[q][0], dd0))));
      dd1 = fmaf(ud_s[A + j], m3, fmaf(u1, m3d, fmaf(td, x[q][1], fmaf(t, xd[q][1], dd1))));
      dd2 = fmaf(ud_s[2 * A + j], m3, fmaf(u2, m3d, fmaf(td, x[q][2], fmaf(t, xd[q][2], dd2))));
    }
  }
  const size_t ni = (size_t)bi * F3 + f;
  ds[(size_t)bi * F + f] = s0;
  dsd[(size_t)bi * F + f] = sd0;
  dv[ni] = d0;
  dv[ni + F] = d1;
  dv[ni + 2 * F] = d2;
  dvd[ni] = dd0;
  dvd[ni + F] = dd1;
  dvd[ni + 2 * F] = dd2;
}

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

// a stage's dynamic shared memory: `unit_sets` [3][A] tables (unit_t, and unitd_t in C and D)
// and B's double-buffered pair sums of `sum_threads` threads
size_t stage_smem(int A, int unit_sets, int sum_threads) {
  return sizeof(float) * (3 * (size_t)unit_sets * A + 2 * (size_t)sum_threads);
}

int stage_threads(int F) { return round_up(F, 32); }

// a stage's launch, one block per (b, atom) and a thread a channel: the SMAXT instance up to
// SMAXT channels, the 1024 one beyond
template <typename K1, typename K2, typename... Args>
cudaError_t launch_stage(K1 small, K2 large, int blocks, int F, size_t smem, cudaStream_t st,
                         Args... args) {
  const int threads = stage_threads(F);
  const auto run = [&](auto kernel) {
    cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, threads, smem, st>>>(args...);
    return cudaGetLastError();
  };
  return threads <= SMAXT ? run(small) : run(large);
}

// ---------------------------------------------------------------------------
// on the host: the live pairs, the radial products and gW on the engine
// ---------------------------------------------------------------------------

// what a call carves from its scratch
struct Work {
  float *x1, *x2;  // the products' compact rows [rows, ld]: wm, and rp (B) or wmd (C, D)
  int *flags, *eidx, *pos, *rs, *n_rows;
  int* row;        // sender order (B, D): the pair rows of the listed slots
  Engine en;
};

long long pair_rows(int B, int A) { return (long long)B * A * A; }

// the weight-gradient partials of gW [R, ld] over `rows` row slots (the split is sized from
// the shapes only, so each bucket gives the same bits every run)
long long gw_part_floats(long long rows, int R, int ld) {
  return wgrad_part_floats(rows, {tprob({TSeg{}}, A_GATHER, R, ld, nullptr, ld)});
}

// `sets` sets of compact rows, the weights' TF32 halves and, with gw, gW's partials
long long scratch_floats(int B, int A, int R, int ld, int sets, bool gw) {
  const long long rows = pair_rows(B, A);
  return sets * rows * ld + 2LL * ld * R + (gw ? gw_part_floats(rows, R, ld) : 0);
}

// the flags, the list, its positions, each segment's first row and the count; in sender order
// the pair rows too
long long scratch_ints(int B, int A, bool by_sender) {
  return (by_sender ? 4 : 3) * pair_rows(B, A) + (long long)B * A + 2;
}

Work carve(int B, int A, int R, int ld, int sets, bool gw, bool by_sender, float* f, int* iw) {
  const long long rows = pair_rows(B, A), prep_n = 2LL * ld * R;
  Work w{};
  w.x1 = f;
  w.x2 = sets > 1 ? f + rows * ld : nullptr;
  float* prep = f + sets * rows * ld;
  w.flags = iw;
  w.eidx = iw + rows;
  w.pos = iw + 2 * rows;
  w.rs = iw + 3 * rows;
  w.n_rows = w.rs + (long long)B * A + 1;
  w.row = by_sender ? w.n_rows + 1 : nullptr;
  // the engine gathers pair rows (b, i, j): in receiver order the list's own entries, in
  // sender order those of the listed slots
  w.en = Engine{rows, w.n_rows, by_sender ? w.row : w.eidx, prep, prep_n, prep + prep_n,
                gw ? gw_part_floats(rows, R, ld) : 0};
  return w;
}

// the live pairs (rows of rbf or t2 that are not zero), in receiver order (the engine's
// live_rows over segments of A pair rows) or in sender order (slots (b, j, i), then their pair
// rows), with each segment's first row
cudaError_t live_pairs(const Work& w, const float* rbf, const float* t2, int B, int A, int R,
                       bool by_sender, cudaStream_t st) {
  const long long rows = pair_rows(B, A);
  const auto mark = by_sender ? painn_flags_kernel<true> : painn_flags_kernel<false>;
  mark<<<B * A, PF_WARPS * 32, 0, st>>>(rbf, t2, w.flags, A, R);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = live_rows(w.flags, w.eidx, w.pos, w.rs, w.n_rows, rows, A, st);
  if (err != cudaSuccess || !by_sender) return err;
  so2_pair_rows_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(w.eidx, w.n_rows, w.row,
                                                                      A);
  return cudaGetLastError();
}

// x1 = a1 W (and x2 = a2 W where a2 is given) over the live rows (gathered), into their
// compact rows; K = R is a few k tiles, so the launch runs persistent
cudaError_t radial_products(const Work& w, const float* a1, const float* a2, const float* wt,
                            int R, int ld, cudaStream_t st) {
  std::vector<NNProb> probs{prob({seg(a1, R, wt, ld, R)}, ld, EPI_STORE, w.x1, ld)};
  if (a2) probs.push_back(prob({seg(a2, R, wt, ld, R)}, ld, EPI_STORE, w.x2, ld));
  for (NNProb& p : probs) p.gather = 1;
  return launch_products(w.en, probs, st, true);
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

// Every entry point returns a cudaError_t (0 = success), launches on `stream` and does not
// sync. They take R a multiple of 4, F <= 1024, W [R, ld] with ld >= 3F a multiple of 4 and
// 16-byte aligned pair tensors (else cudaErrorInvalidValue), and scratch and iscratch as the
// *_scratch_floats / _ints functions size them.

// float and int scratch of an A call (painn_fwd: sets 1) or a C call (painn_dual_fwd: sets 2)
// on B molecules of A atoms with R radial values and W rows of ld floats
long long painn_fwd_scratch_floats(int B, int A, int R, int ld, int sets) {
  return scratch_floats(B, A, R, ld, sets, false);
}

long long painn_fwd_scratch_ints(int B, int A) { return scratch_ints(B, A, false); }

// Kernel A: every row of ds [B,A,F] and dv [B,A,3F] is written.
int painn_fwd(const float* rbf, const float* phi, const float* v, const float* unit_t,
              const float* w, float* ds, float* dv, float* scratch, int* iscratch, int B, int A,
              int R, int F, int ld, void* stream) {
  if (!shapes_ok(B, A, R, F, ld) || !aligned16(rbf)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(B, A, R, ld, 1, false, false, scratch, iscratch);
  cudaError_t err = live_pairs(wk, rbf, nullptr, B, A, R, false, st);
  if (err == cudaSuccess) err = radial_products(wk, rbf, nullptr, w, R, ld, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stage(painn_fwd_stage_kernel<SMAXT>, painn_fwd_stage_kernel<1024>, B * A, F,
                           stage_smem(A, 1, 0), st, wk.x1, wk.eidx, wk.rs, phi, v, unit_t, ds,
                           dv, A, F, ld);
}

// float and int scratch of a B or D call (painn_bwd, painn_dual_bwd)
long long painn_bwd_scratch_floats(int B, int A, int R, int ld) {
  return scratch_floats(B, A, R, ld, 2, true);
}

long long painn_bwd_scratch_ints(int B, int A) { return scratch_ints(B, A, true); }

// Kernel B: gdist [B,A,A] and gut [B,A,3,A] must hold zeros (only live pairs are written); gw
// [R, ld] is written only when need_gw != 0.
int painn_bwd(const float* rbf, const float* rbfp, const float* phi, const float* v,
              const float* unit_t, const float* w, const float* gds, const float* gdv,
              float* gdist, float* gut, float* gphi, float* gv, float* gw, float* scratch,
              int* iscratch, int need_gw, int B, int A, int R, int F, int ld, void* stream) {
  if (!shapes_ok(B, A, R, F, ld) || !aligned16(rbf) || !aligned16(rbfp))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(B, A, R, ld, 2, true, true, scratch, iscratch);
  cudaError_t err = live_pairs(wk, rbf, rbfp, B, A, R, true, st);
  if (err == cudaSuccess) err = radial_products(wk, rbf, rbfp, w, R, ld, st);
  if (err == cudaSuccess)
    err = launch_stage(painn_bwd_stage_kernel<SMAXT>, painn_bwd_stage_kernel<1024>, B * A, F,
                       stage_smem(A, 1, stage_threads(F)), st, wk.x1, wk.x2, wk.eidx, wk.rs,
                       phi, v, unit_t, gds, gdv, gdist, gut, gphi, gv, need_gw, A, F, ld);
  if (err != cudaSuccess || !need_gw) return (int)err;
  return (int)weight_grad(wk, rbf, nullptr, gw, R, ld, st);
}

// Kernel C: as A (its live pairs are those of rbf or rbfd).
int painn_dual_fwd(const float* rbf, const float* rbfd, const float* phi, const float* phid,
                   const float* v, const float* vd, const float* unit_t, const float* unitd_t,
                   const float* w, float* ds, float* dv, float* dsd, float* dvd, float* scratch,
                   int* iscratch, int B, int A, int R, int F, int ld, void* stream) {
  if (!shapes_ok(B, A, R, F, ld) || !aligned16(rbf) || !aligned16(rbfd))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve(B, A, R, ld, 2, false, false, scratch, iscratch);
  cudaError_t err = live_pairs(wk, rbf, rbfd, B, A, R, false, st);
  if (err == cudaSuccess) err = radial_products(wk, rbf, rbfd, w, R, ld, st);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_stage(painn_dual_fwd_stage_kernel<SMAXT>,
                           painn_dual_fwd_stage_kernel<1024>, B * A, F, stage_smem(A, 2, 0), st,
                           wk.x1, wk.x2, wk.eidx, wk.rs, phi, phid, v, vd, unit_t, unitd_t, ds,
                           dv, dsd, dvd, A, F, ld);
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
  const Work wk = carve(B, A, R, ld, 2, true, true, scratch, iscratch);
  cudaError_t err = live_pairs(wk, rbf, rbfd, B, A, R, true, st);
  if (err == cudaSuccess) err = radial_products(wk, rbf, rbfd, w, R, ld, st);
  if (err == cudaSuccess)
    err = launch_stage(painn_dual_bwd_stage_kernel<SMAXT>, painn_dual_bwd_stage_kernel<1024>,
                       B * A, F, stage_smem(A, 2, 0), st, wk.x1, wk.x2, wk.eidx, wk.rs, phi,
                       phid, v, vd, unit_t, unitd_t, gds, gdv, gdsd, gdvd, gphi, gphid, gv, gvd,
                       need_gw, A, F, ld);
  if (err != cudaSuccess || !need_gw) return (int)err;
  return (int)weight_grad(wk, rbf, rbfd, gw, R, ld, st);
}

}  // extern "C"
