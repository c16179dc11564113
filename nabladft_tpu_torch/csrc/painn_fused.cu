// Fused PaiNN message kernels for Hopper (sm_90a), fp32 FMA.
//
// Kernel A, painn_fwd_kernel, replaces nabladft_tpu/ops/pallas/painn_fused.py
// `_fwd_kernel` (launched by `_run_fwd`'s pallas_call):
//   wm   = rbf @ W                         W [R, 3F], three F-wide slices k
//   ds_i = sum_j wm0[i,j] * phi0_j
//   dv_ic = sum_j wm1[i,j] * phi1_j * v_jc + sum_j u_c(j->i) * wm2[i,j] * phi2_j
// Kernel B, painn_bwd_kernel + painn_bwd_gw_kernel + painn_gw_reduce_kernel,
// replaces `_bwd_kernel` (launched by `_run_bwd`'s pallas_call): the VJP of A,
// with the radial chain folded into g_dist through rbfp = d(basis*env)/d dist.
//
// Layouts (as the JAX op): rbf, rbfp [B,A,A,R]; phi, v, gdv, dv [B,A,3F] with
// v c-major (slice c*F:(c+1)*F is component c); unit_t [B,A,3,A] with
// unit_t[b,i,c,j] = unit(j->i)_c; ds, gds [B,A,F]; all float32, contiguous.
//
// What bounds them on the card: the three [A,R]x[R,F] products per molecule
// row (and six in B, nine with the weight gradient) make both kernels compute
// bound on the fp32 FMA rate: at B=64, A=48, R=100, F=128 kernel A does about
// 12 GFLOP against about 0.07 GB of traffic. The design keeps every [A,A,F]
// intermediate (wm, rbfp@W, the per-pair cotangents) in registers and never in
// device memory, and stages the pair rows in shared memory so each rbf value
// is read from device memory once per block:
//   * A: one block per (molecule b, receiver i). The block stages rbf[b,i]
//     ([A,R]) and unit_t[b,i] in shared memory; each thread owns one channel
//     f and a group of senders j, forms wm for JB senders at a time in
//     registers (one W load feeds JB FMAs, rbf rows are read as float4
//     broadcasts) and folds them straight into its partial ds / dv sums. The
//     sender groups are summed through shared memory at the end: no sum
//     crosses blocks.
//   * B: the outputs reduce along three axes. g_dist[b,i,j] and
//     g_unit_t[b,i,:,j] reduce over channels; gphi[b,j] and gv[b,j] over
//     receivers i. One block per (molecule b, SENDER j) owns both kinds: it
//     stages rbf[b,:,j] and rbfp[b,:,j], loops over receivers in register
//     blocks, sums node cotangents in registers, and reduces the per-pair
//     channel sums with warp shuffles into shared memory. No atomics, so the
//     result is the same on every run.
//   * gW [R,3F] reduces over every pair of every molecule. A second kernel
//     recomputes the cheap per-pair cotangent gwm from node tensors (no
//     [B,A,A,3F] tensor exists) and writes one [R,3F] partial per molecule;
//     a third sums the partials in a fixed order. These run only when the
//     weight gradient is asked for (not on the predict path).
//
// Kernel C, painn_dual_fwd_kernel, replaces `_dual_fwd_kernel` (launched by
// `_run_dual_fwd`): A's primal lane plus its tangent lane along
// (rbfd, phid, vd, unitd_t), with wmd = rbfd @ W:
//   dsd_i  = sum_j wmd0 phi0_j + wm0 phid0_j
//   dvd_ic = sum_j (wmd1 phi1_j + wm1 phid1_j) v_jc + wm1 phi1_j vd_jc
//          + sum_j ud_c (wm2 phi2_j) + u_c (wmd2 phi2_j + wm2 phid2_j)
// Kernel D, painn_dual_bwd_kernel + painn_dual_bwd_gw_kernel + the reduce,
// replaces `_dual_bwd_kernel` (launched by `_run_dual_bwd`): the VJP of C for
// the node inputs and W only (no pair cotangents).
//   * C is receiver-owned like A: one block per (b, i) stages rbf[b,i] and
//     rbfd[b,i] and runs both [A,R]x[R,F] products per register block (one
//     W load feeds both), so the tangent lane doubles the FMAs, not the
//     traffic.
//   * D is sender-owned like B: every output (gphi, gphid, gv, gvd) is a sum
//     over receivers i, so one block per (b, j) owns its outputs, stages
//     rbf[b,:,j] and rbfd[b,:,j], and needs no atomics. The main loop sums
//     only per-pair products of the cotangents with wm / wmd; phi_j, v_j and
//     their tangents enter once per block in the epilogue.
//   * D's gW = sum over pairs of rbf^T gwm + rbfd^T gwmd: as B's, a second
//     kernel recomputes gwm / gwmd from node tensors and writes one [R,3F]
//     partial per molecule, and the reduce kernel sums them in a fixed order,
//     so D gives the same bits on every run.
// Plain FMA only: no TF32, no tensor cores (a later step).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block (A and B)
constexpr int FT = 128;       // channel lanes per block
constexpr int GROUPS = NT / FT;  // row groups sharing a channel lane (2)
constexpr int JB = 8;         // rows per register block
constexpr int NWF = FT / 32;  // warps across the channel lanes (4)

// gW tiles
constexpr int GW_RH = 7;      // row slots per thread (16 threads down a column)
constexpr int GW_RT = 16 * GW_RH;  // r rows per block (112 >= R = 100)
constexpr int GW_NT = 64;     // output columns (of 3F) per block
constexpr int GW_PT = 32;     // pairs per shared-memory chunk

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows padded so each of the GROUPS row groups holds whole JB blocks
__host__ __device__ inline int padded_rows(int a) { return round_up(a, JB * GROUPS); }

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// two row sets against one weight column (B: wm and rbfp@W together)
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

size_t bwd_smem_bytes(int A, int R) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4);
  return sizeof(float) * (2 * (size_t)Ap * Rp + 3 * Ap + (size_t)NWF * Ap * 4 + (GROUPS - 1) * 6 * FT);
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
// kernel B: pair and node cotangents, one block per (molecule b, sender j)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) painn_bwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfp, const float* __restrict__ phi,
    const float* __restrict__ v, const float* __restrict__ ut, const float* __restrict__ w,
    const float* __restrict__ gds, const float* __restrict__ gdv,
    float* __restrict__ gdist, float* __restrict__ gut, float* __restrict__ gphi,
    float* __restrict__ gv, int A, int R, int F) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Ap = padded_rows(A), Rp = round_up(R, 4), F3 = 3 * F;
  float* rbf_s = smem;                  // [Ap][Rp]  rbf[b,i,j,:] by receiver i
  float* rbfp_s = rbf_s + Ap * Rp;      // [Ap][Rp]
  float* u_s = rbfp_s + Ap * Rp;        // [3][Ap]   unit_t[b,i,c,j]
  float* red_pair = u_s + 3 * Ap;       // [NWF][Ap][4]: g_dist, g_unit_t c=0..2
  float* red_node = red_pair + NWF * Ap * 4;  // [GROUPS-1][6][FT]

  const int bj = blockIdx.x;            // b*A + j
  const int b = bj / A, j = bj - b * A;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < Ap * Rp; idx += NT) {
    const int i = idx / Rp, r = idx - i * Rp;
    const bool in = i < A && r < R;
    const size_t src = (((size_t)b * A + i) * A + j) * R + r;
    rbf_s[idx] = in ? rbf[src] : 0.f;
    rbfp_s[idx] = in ? rbfp[src] : 0.f;
  }
  for (int idx = tid; idx < 3 * Ap; idx += NT) {
    const int c = idx / Ap, i = idx - c * Ap;
    u_s[idx] = i < A ? ut[(((size_t)b * A + i) * 3 + c) * A + j] : 0.f;
  }
  for (int idx = tid; idx < NWF * Ap * 4; idx += NT) red_pair[idx] = 0.f;
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT, lane = tid % 32, fw = fl / 32;
  const int rows = Ap / GROUPS;

  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float* pj = phi + ((size_t)b * A + j) * F3;
    const float* vj = v + ((size_t)b * A + j) * F3;
    const float p0 = active ? pj[f] : 0.f, p1 = active ? pj[F + f] : 0.f;
    const float p2 = active ? pj[2 * F + f] : 0.f;
    const float v0 = active ? vj[f] : 0.f, v1 = active ? vj[F + f] : 0.f;
    const float v2 = active ? vj[2 * F + f] : 0.f;
    float a_phi0 = 0.f, a_phi1 = 0.f, a_phi2 = 0.f, a_v0 = 0.f, a_v1 = 0.f, a_v2 = 0.f;

    for (int i0 = grp * rows; i0 < (grp + 1) * rows; i0 += JB) {
      float gd[JB], gu0[JB], gu1[JB], gu2[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) gd[q] = gu0[q] = gu1[q] = gu2[q] = 0.f;
      for (int k = 0; k < 3; ++k) {
        float wm[JB], rp[JB];
#pragma unroll
        for (int q = 0; q < JB; ++q) wm[q] = rp[q] = 0.f;
        row_block_dot2(rbf_s, rbfp_s, i0, Rp, R, w + k * F + (active ? f : 0), F3, wm, rp);
        if (!active) continue;
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int i = i0 + q;
          if (i >= A) continue;
          const size_t node = (size_t)b * A + i;
          if (k == 0) {
            const float g1 = gds[node * F + f];
            gd[q] = fmaf(g1 * p0, rp[q], gd[q]);
            a_phi0 = fmaf(g1, wm[q], a_phi0);
          } else {
            const float* g2 = gdv + node * F3;
            const float g20 = g2[f], g21 = g2[F + f], g22 = g2[2 * F + f];
            if (k == 1) {
              const float gwm = p1 * (g20 * v0 + g21 * v1 + g22 * v2);
              gd[q] = fmaf(gwm, rp[q], gd[q]);
              const float s0 = g20 * wm[q], s1 = g21 * wm[q], s2 = g22 * wm[q];
              a_phi1 += s0 * v0 + s1 * v1 + s2 * v2;
              a_v0 = fmaf(s0, p1, a_v0);
              a_v1 = fmaf(s1, p1, a_v1);
              a_v2 = fmaf(s2, p1, a_v2);
            } else {
              const float pa = u_s[i] * g20 + u_s[Ap + i] * g21 + u_s[2 * Ap + i] * g22;
              gd[q] = fmaf(pa * p2, rp[q], gd[q]);
              const float m3 = wm[q] * p2;
              gu0[q] = fmaf(m3, g20, gu0[q]);
              gu1[q] = fmaf(m3, g21, gu1[q]);
              gu2[q] = fmaf(m3, g22, gu2[q]);
              a_phi2 = fmaf(pa, wm[q], a_phi2);
            }
          }
        }
      }
      // channel sums of the per-pair values: warp shuffles, then one lane per
      // warp adds into its own slot (fixed order, no two writers per slot)
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const float s_gd = warp_sum(gd[q]);
        const float s_u0 = warp_sum(gu0[q]);
        const float s_u1 = warp_sum(gu1[q]);
        const float s_u2 = warp_sum(gu2[q]);
        const int i = i0 + q;
        if (lane == 0 && i < A) {
          float* slot = red_pair + ((size_t)fw * Ap + i) * 4;
          slot[0] += s_gd;
          slot[1] += s_u0;
          slot[2] += s_u1;
          slot[3] += s_u2;
        }
      }
    }
    if (grp > 0) {
      float* rg = red_node + (size_t)(grp - 1) * 6 * FT;
      rg[fl] = a_phi0;
      rg[FT + fl] = a_phi1;
      rg[2 * FT + fl] = a_phi2;
      rg[3 * FT + fl] = a_v0;
      rg[4 * FT + fl] = a_v1;
      rg[5 * FT + fl] = a_v2;
    }
    __syncthreads();
    if (grp == 0 && active) {
      for (int g = 1; g < GROUPS; ++g) {
        const float* rg = red_node + (size_t)(g - 1) * 6 * FT;
        a_phi0 += rg[fl];
        a_phi1 += rg[FT + fl];
        a_phi2 += rg[2 * FT + fl];
        a_v0 += rg[3 * FT + fl];
        a_v1 += rg[4 * FT + fl];
        a_v2 += rg[5 * FT + fl];
      }
      float* go = gphi + (size_t)bj * F3;
      go[f] = a_phi0;
      go[F + f] = a_phi1;
      go[2 * F + f] = a_phi2;
      float* gvo = gv + (size_t)bj * F3;
      gvo[f] = a_v0;
      gvo[F + f] = a_v1;
      gvo[2 * F + f] = a_v2;
    }
    __syncthreads();
  }

  for (int i = tid; i < A; i += NT) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < NWF; ++g)
      for (int t = 0; t < 4; ++t) s[t] += red_pair[((size_t)g * Ap + i) * 4 + t];
    const size_t pair = ((size_t)b * A + i) * A + j;
    gdist[pair] = s[0];
    for (int c = 0; c < 3; ++c) gut[(((size_t)b * A + i) * 3 + c) * A + j] = s[1 + c];
  }
}

// ---------------------------------------------------------------------------
// kernel B, weight gradient: per-molecule partials gw_part[b] = rbf[b]^T gwm[b]
// A block covers GW_RT rows (all of R = 100) and GW_NT columns of [R, 3F],
// so the per-pair cotangent tile y_s is computed once per pair chunk; each
// thread accumulates GW_RH rows x 4 columns.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) painn_bwd_gw_kernel(
    const float* __restrict__ rbf, const float* __restrict__ phi, const float* __restrict__ v,
    const float* __restrict__ ut, const float* __restrict__ gds, const float* __restrict__ gdv,
    float* __restrict__ gw_part, int A, int R, int F) {
  __shared__ float x_s[GW_PT][GW_RT];
  __shared__ float y_s[GW_PT][GW_NT];
  const int F3 = 3 * F;
  const int n0 = blockIdx.x * GW_NT, r0 = blockIdx.y * GW_RT, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tn = tid % 16;  // rows tr + 16*h; cols tn + 16*q
  const int P = A * A;
  const float* rb = rbf + (size_t)b * P * R;
  float acc[GW_RH][4];
#pragma unroll
  for (int h = 0; h < GW_RH; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[h][q] = 0.f;

  for (int p0 = 0; p0 < P; p0 += GW_PT) {
    for (int idx = tid; idx < GW_PT * GW_RT; idx += NT) {
      const int pp = idx / GW_RT, rr = idx - pp * GW_RT;
      const int p = p0 + pp, r = r0 + rr;
      x_s[pp][rr] = (p < P && r < R) ? rb[(size_t)p * R + r] : 0.f;
    }
    for (int idx = tid; idx < GW_PT * GW_NT; idx += NT) {
      const int pp = idx / GW_NT, nn = idx - pp * GW_NT;
      const int p = p0 + pp, n = n0 + nn;
      float y = 0.f;
      if (p < P && n < F3) {
        const int i = p / A, jj = p - i * A;
        const int k = n / F, f = n - k * F;
        const size_t ni = (size_t)b * A + i, nj = (size_t)b * A + jj;
        const float* pj = phi + nj * F3;
        if (k == 0) {
          y = gds[ni * F + f] * pj[f];
        } else {
          const float* g2 = gdv + ni * F3;
          if (k == 1) {
            const float* vj = v + nj * F3;
            y = pj[F + f] * (g2[f] * vj[f] + g2[F + f] * vj[F + f] + g2[2 * F + f] * vj[2 * F + f]);
          } else {
            const float* u = ut + ni * 3 * A + jj;
            y = pj[2 * F + f] * (u[0] * g2[f] + u[A] * g2[F + f] + u[2 * A] * g2[2 * F + f]);
          }
        }
      }
      y_s[pp][nn] = y;
    }
    __syncthreads();
#pragma unroll 2
    for (int pp = 0; pp < GW_PT; ++pp) {
      float y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) y[q] = y_s[pp][tn + 16 * q];
#pragma unroll
      for (int h = 0; h < GW_RH; ++h) {
        const float x = x_s[pp][tr + 16 * h];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(x, y[q], acc[h][q]);
      }
    }
    __syncthreads();
  }
  float* out = gw_part + (size_t)b * R * F3;
#pragma unroll
  for (int h = 0; h < GW_RH; ++h) {
    const int r = r0 + tr + 16 * h;
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tn + 16 * q;
      if (n < F3) out[(size_t)r * F3 + n] = acc[h][q];
    }
  }
}

__global__ void painn_gw_reduce_kernel(const float* __restrict__ gw_part, float* __restrict__ gw,
                                       int B, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += gw_part[(size_t)b * n + idx];
  gw[idx] = s;
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
// kernel D: node cotangents, one block per (molecule b, sender j)
// ---------------------------------------------------------------------------

constexpr int D_ACC = 10;  // gphi0, gphid0, s0..2, sd0..2, gphi2, gphid2

size_t dual_bwd_smem_bytes(int A, int R) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4);
  return sizeof(float) * (2 * (size_t)Ap * Rp + 6 * Ap + (GROUPS - 1) * D_ACC * FT);
}

__global__ void __launch_bounds__(NT) painn_dual_bwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfd, const float* __restrict__ phi,
    const float* __restrict__ phid, const float* __restrict__ v, const float* __restrict__ vd,
    const float* __restrict__ ut, const float* __restrict__ utd, const float* __restrict__ w,
    const float* __restrict__ gds, const float* __restrict__ gdv, const float* __restrict__ gdsd,
    const float* __restrict__ gdvd, float* __restrict__ gphi, float* __restrict__ gphid,
    float* __restrict__ gv, float* __restrict__ gvd, int A, int R, int F) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int Ap = padded_rows(A), Rp = round_up(R, 4), F3 = 3 * F;
  float* rbf_s = smem;              // [Ap][Rp]  rbf[b,i,j,:] by receiver i
  float* rbfd_s = rbf_s + Ap * Rp;  // [Ap][Rp]
  float* u_s = rbfd_s + Ap * Rp;    // [3][Ap]   unit_t[b,i,c,j]
  float* ud_s = u_s + 3 * Ap;       // [3][Ap]   unitd_t[b,i,c,j]
  float* red = ud_s + 3 * Ap;       // [GROUPS-1][D_ACC][FT]

  const int bj = blockIdx.x;        // b*A + j
  const int b = bj / A, j = bj - b * A;
  const int tid = threadIdx.x;

  for (int idx = tid; idx < Ap * Rp; idx += NT) {
    const int i = idx / Rp, r = idx - i * Rp;
    const bool in = i < A && r < R;
    const size_t src = (((size_t)b * A + i) * A + j) * R + r;
    rbf_s[idx] = in ? rbf[src] : 0.f;
    rbfd_s[idx] = in ? rbfd[src] : 0.f;
  }
  for (int idx = tid; idx < 3 * Ap; idx += NT) {
    const int c = idx / Ap, i = idx - c * Ap;
    const size_t src = (((size_t)b * A + i) * 3 + c) * A + j;
    u_s[idx] = i < A ? ut[src] : 0.f;
    ud_s[idx] = i < A ? utd[src] : 0.f;
  }
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT;
  const int rows = Ap / GROUPS;

  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    float acc[D_ACC];
#pragma unroll
    for (int t = 0; t < D_ACC; ++t) acc[t] = 0.f;
    float &a0 = acc[0], &ad0 = acc[1], &s0 = acc[2], &s1 = acc[3], &s2 = acc[4];
    float &sd0 = acc[5], &sd1 = acc[6], &sd2 = acc[7], &a2 = acc[8], &ad2 = acc[9];

    for (int i0 = grp * rows; i0 < (grp + 1) * rows; i0 += JB) {
      for (int k = 0; k < 3; ++k) {
        float wm[JB], wmd[JB];
#pragma unroll
        for (int q = 0; q < JB; ++q) wm[q] = wmd[q] = 0.f;
        row_block_dot2(rbf_s, rbfd_s, i0, Rp, R, w + k * F + (active ? f : 0), F3, wm, wmd);
        if (!active) continue;
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int i = i0 + q;
          if (i >= A) continue;
          const size_t node = (size_t)b * A + i;
          if (k == 0) {
            const float g1 = gds[node * F + f], g1d = gdsd[node * F + f];
            a0 = fmaf(g1, wm[q], fmaf(g1d, wmd[q], a0));
            ad0 = fmaf(g1d, wm[q], ad0);
          } else {
            const float* g2 = gdv + node * F3;
            const float* g2d = gdvd + node * F3;
            const float g20 = g2[f], g21 = g2[F + f], g22 = g2[2 * F + f];
            const float h0 = g2d[f], h1 = g2d[F + f], h2 = g2d[2 * F + f];
            if (k == 1) {
              s0 = fmaf(g20, wm[q], fmaf(h0, wmd[q], s0));
              s1 = fmaf(g21, wm[q], fmaf(h1, wmd[q], s1));
              s2 = fmaf(g22, wm[q], fmaf(h2, wmd[q], s2));
              sd0 = fmaf(h0, wm[q], sd0);
              sd1 = fmaf(h1, wm[q], sd1);
              sd2 = fmaf(h2, wm[q], sd2);
            } else {
              const float u0 = u_s[i], u1 = u_s[Ap + i], u2 = u_s[2 * Ap + i];
              const float pa = fmaf(ud_s[2 * Ap + i], h2, fmaf(ud_s[Ap + i], h1, fmaf(ud_s[i], h0,
                               fmaf(u2, g22, fmaf(u1, g21, u0 * g20)))));
              const float pb = fmaf(u2, h2, fmaf(u1, h1, u0 * h0));
              a2 = fmaf(pa, wm[q], fmaf(pb, wmd[q], a2));
              ad2 = fmaf(pb, wm[q], ad2);
            }
          }
        }
      }
    }
    if (grp > 0) {
      float* rg = red + (size_t)(grp - 1) * D_ACC * FT;
#pragma unroll
      for (int t = 0; t < D_ACC; ++t) rg[t * FT + fl] = acc[t];
    }
    __syncthreads();
    if (grp == 0 && active) {
      for (int g = 1; g < GROUPS; ++g) {
        const float* rg = red + (size_t)(g - 1) * D_ACC * FT;
#pragma unroll
        for (int t = 0; t < D_ACC; ++t) acc[t] += rg[t * FT + fl];
      }
      // epilogue: the node factors of sender j
      const size_t nj = (size_t)bj * F3;
      const float p1 = phi[nj + F + f], pd1 = phid[nj + F + f];
      const float v0 = v[nj + f], v1 = v[nj + F + f], v2 = v[nj + 2 * F + f];
      const float e0 = vd[nj + f], e1 = vd[nj + F + f], e2 = vd[nj + 2 * F + f];
      gphi[nj + f] = a0;
      gphi[nj + F + f] = fmaf(sd2, e2, fmaf(sd1, e1, fmaf(sd0, e0,
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
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// kernel D, weight gradient: gw_part[b] = rbf[b]^T gwm[b] + rbfd[b]^T gwmd[b],
// tiled as B's gW kernel, with a second (rbfd, gwmd) tile pair per chunk.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) painn_dual_bwd_gw_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfd, const float* __restrict__ phi,
    const float* __restrict__ phid, const float* __restrict__ v, const float* __restrict__ vd,
    const float* __restrict__ ut, const float* __restrict__ utd, const float* __restrict__ gds,
    const float* __restrict__ gdv, const float* __restrict__ gdsd, const float* __restrict__ gdvd,
    float* __restrict__ gw_part, int A, int R, int F) {
  __shared__ float x_s[GW_PT][GW_RT];
  __shared__ float xd_s[GW_PT][GW_RT];
  __shared__ float y_s[GW_PT][GW_NT];
  __shared__ float yd_s[GW_PT][GW_NT];
  const int F3 = 3 * F;
  const int n0 = blockIdx.x * GW_NT, r0 = blockIdx.y * GW_RT, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tn = tid % 16;  // rows tr + 16*h; cols tn + 16*q
  const int P = A * A;
  const float* rb = rbf + (size_t)b * P * R;
  const float* rbd = rbfd + (size_t)b * P * R;
  float acc[GW_RH][4];
#pragma unroll
  for (int h = 0; h < GW_RH; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[h][q] = 0.f;

  for (int p0 = 0; p0 < P; p0 += GW_PT) {
    for (int idx = tid; idx < GW_PT * GW_RT; idx += NT) {
      const int pp = idx / GW_RT, rr = idx - pp * GW_RT;
      const int p = p0 + pp, r = r0 + rr;
      const bool in = p < P && r < R;
      x_s[pp][rr] = in ? rb[(size_t)p * R + r] : 0.f;
      xd_s[pp][rr] = in ? rbd[(size_t)p * R + r] : 0.f;
    }
    for (int idx = tid; idx < GW_PT * GW_NT; idx += NT) {
      const int pp = idx / GW_NT, nn = idx - pp * GW_NT;
      const int p = p0 + pp, n = n0 + nn;
      float y = 0.f, yd = 0.f;
      if (p < P && n < F3) {
        const int i = p / A, jj = p - i * A;
        const int k = n / F, f = n - k * F;
        const size_t ni = (size_t)b * A + i, nj = (size_t)b * A + jj;
        const float pk = phi[nj * F3 + n], pdk = phid[nj * F3 + n];
        if (k == 0) {
          const float g1 = gds[ni * F + f], g1d = gdsd[ni * F + f];
          y = fmaf(g1, pk, g1d * pdk);
          yd = g1d * pk;
        } else {
          const float* g2 = gdv + ni * F3;
          const float* g2d = gdvd + ni * F3;
          if (k == 1) {
            const float* vj = v + nj * F3;
            const float* vdj = vd + nj * F3;
            const float s1 = fmaf(g2d[2 * F + f], vdj[2 * F + f], fmaf(g2d[F + f], vdj[F + f],
                             fmaf(g2d[f], vdj[f], fmaf(g2[2 * F + f], vj[2 * F + f],
                             fmaf(g2[F + f], vj[F + f], g2[f] * vj[f])))));
            const float s2 = fmaf(g2d[2 * F + f], vj[2 * F + f],
                             fmaf(g2d[F + f], vj[F + f], g2d[f] * vj[f]));
            y = fmaf(pk, s1, pdk * s2);
            yd = pk * s2;
          } else {
            const float* u = ut + ni * 3 * A + jj;
            const float* ud = utd + ni * 3 * A + jj;
            const float pa = fmaf(ud[2 * A], g2d[2 * F + f], fmaf(ud[A], g2d[F + f],
                             fmaf(ud[0], g2d[f], fmaf(u[2 * A], g2[2 * F + f],
                             fmaf(u[A], g2[F + f], u[0] * g2[f])))));
            const float pb = fmaf(u[2 * A], g2d[2 * F + f], fmaf(u[A], g2d[F + f], u[0] * g2d[f]));
            y = fmaf(pa, pk, pb * pdk);
            yd = pb * pk;
          }
        }
      }
      y_s[pp][nn] = y;
      yd_s[pp][nn] = yd;
    }
    __syncthreads();
#pragma unroll 2
    for (int pp = 0; pp < GW_PT; ++pp) {
      float y[4], yd[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        y[q] = y_s[pp][tn + 16 * q];
        yd[q] = yd_s[pp][tn + 16 * q];
      }
#pragma unroll
      for (int h = 0; h < GW_RH; ++h) {
        const float x = x_s[pp][tr + 16 * h], xd = xd_s[pp][tr + 16 * h];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(xd, yd[q], fmaf(x, y[q], acc[h][q]));
      }
    }
    __syncthreads();
  }
  float* out = gw_part + (size_t)b * R * F3;
#pragma unroll
  for (int h = 0; h < GW_RH; ++h) {
    const int r = r0 + tr + 16 * h;
    if (r >= R) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tn + 16 * q;
      if (n < F3) out[(size_t)r * F3 + n] = acc[h][q];
    }
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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

// gw_part ([B,R,3F] scratch) and gw are used only when need_gw != 0.
int painn_bwd(const float* rbf, const float* rbfp, const float* phi, const float* v,
              const float* unit_t, const float* w, const float* gds, const float* gdv,
              float* gdist, float* gut, float* gphi, float* gv, float* gw_part, float* gw,
              int need_gw, int B, int A, int R, int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = bwd_smem_bytes(A, R);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(painn_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  painn_bwd_kernel<<<B * A, NT, smem, s>>>(rbf, rbfp, phi, v, unit_t, w, gds, gdv,
                                           gdist, gut, gphi, gv, A, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess || !need_gw) return (int)err;
  const dim3 grid((3 * F + GW_NT - 1) / GW_NT, (R + GW_RT - 1) / GW_RT, B);
  painn_bwd_gw_kernel<<<grid, NT, 0, s>>>(rbf, phi, v, unit_t, gds, gdv, gw_part, A, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = R * 3 * F;
  painn_gw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(gw_part, gw, B, n);
  return (int)cudaGetLastError();
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

// gw_part ([B,R,3F] scratch) and gw are used only when need_gw != 0.
int painn_dual_bwd(const float* rbf, const float* rbfd, const float* phi, const float* phid,
                   const float* v, const float* vd, const float* unit_t, const float* unitd_t,
                   const float* w, const float* gds, const float* gdv, const float* gdsd,
                   const float* gdvd, float* gphi, float* gphid, float* gv, float* gvd,
                   float* gw_part, float* gw, int need_gw, int B, int A, int R, int F,
                   void* stream) {
  if (B == 0 || A == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = dual_bwd_smem_bytes(A, R);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(painn_dual_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  painn_dual_bwd_kernel<<<B * A, NT, smem, s>>>(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t, w,
                                                gds, gdv, gdsd, gdvd, gphi, gphid, gv, gvd,
                                                A, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess || !need_gw) return (int)err;
  const dim3 grid((3 * F + GW_NT - 1) / GW_NT, (R + GW_RT - 1) / GW_RT, B);
  painn_dual_bwd_gw_kernel<<<grid, NT, 0, s>>>(rbf, rbfd, phi, phid, v, vd, unit_t, unitd_t,
                                               gds, gdv, gdsd, gdvd, gw_part, A, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = R * 3 * F;
  painn_gw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(gw_part, gw, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
