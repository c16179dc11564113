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

}  // extern "C"
