// Fused EquiformerV2 SO(2) graph attention for Hopper (sm_90a): kernels O and P.
//
// Kernel O replaces nabladft_tpu/ops/pallas/eqv2_attn.py `_fwd_kernel` (pallas_call in
// `_run_fwd`); kernel P replaces `_bwd_kernel` (`_run_bwd`), the backward of the custom_vjp
// `eqv2_attention_vjp` for x (through the gather), x_i, xe and every weight. For each live
// edge slot (b, i, k) of the K-compacted neighbour list (maskf > 0.5), j = idx[b, i, k]:
//   1. src = D x_j, tgt = D x_i (the m-major truncated stacks [S_t, C], D the masked compact
//      Wigner values d), concatenated by channel: [S_t, 2C];
//   2. scaled per (l, channel) by rad = xe w_rad + b_rad, shared over m;
//   3. SO(2) conv 1: m=0 rows times w1, whose extra columns give the alpha scalars [NH VA]
//      and the gate scalars [CO]; m=1..M the packed fc1 (wr | wi) over the +m and -m rows,
//      recombined as (rp - im, rm + ip);
//   4. silu on the truncated S2 grid (to_g [P, S_t], from_g) for rows 1.., silu(gates) on
//      row 0;
//   5. SO(2) conv 2 (w2, fc2) gives the values [S_t, CO];
//   6. per head: LayerNorm (eps 1e-6) of the alpha scalars, silu, dot with alpha_dot: the
//      logits;
//   7. softmax over the receiver's live edges, times the keep mask dropk;
//   8. the values weighted per head (CO / NH channels a head);
//   9. rotated back with D^T and summed over k: agg[b, i] [S, CO].
//
// Layouts: x, xi [B,A,S,C]; idx [B,A,K] int32; d [B,A,K,KW] (compact, masked); xe
// [B,A,K,EC]; maskf [B,A,K]; dropk [B,A,K,NH]; weights w_rad [EC, (L+1) 2C], b_rad
// [1, (L+1) 2C], w1 [(L+1) 2C, (L+1) CO + NH VA + CO], fc1_m [n_l 2C, 2 n_l CO] per m,
// w2 [(L+1) CO, (L+1) CO], fc2_m [n_l CO, 2 n_l CO] per m, ln_scale, ln_bias, alpha_dot
// [1, NH VA] (ln tiled per head); agg and its cotangent g [B,A,S,CO]; float32, contiguous.
//
// What bounds them on the card: the SO(2) products and the radial product, ~32 of the
// ~35.6 MFLOP per live edge at EquiformerV2's widths (L 6, M 2, C 128, CO 128, EC 384, NH 8,
// VA 64; the JAX package's FLOP model without its one-hot gather): a batch of 64 molecules
// at A=48 is ~3 TFLOP forward. In fp32-accurate arithmetic that is the tensor cores' 3xTF32
// rate (495 / 3 TFLOP/s on an H100 SXM), not the fp32 FMA rate (67).
// What the design does about it:
//   * The TPU kernel runs one program per block of receivers with their K-row blocks in
//     VMEM, gathers neighbours with a one-hot matmul (Mosaic has no sublane gather) and
//     reduces per head with 0/1 expander matmuls. None of that is carried over: the
//     products run over ALL live edges of the batch at once on so2_common.cuh's engine
//     (3xTF32 wgmma, 128 x 128 tiles fed by TMA / cp.async through an mbarrier ring, each
//     weight tile feeding 128 edge rows), neighbours are gathered by index, and the
//     per-head reductions are warp shuffles.
//   * A scan lists the live edges in (b, i, k) order on the card (no host sync); scratch
//     is sized by the B·A·K edge slots, never by B·A². A receiver's edges are contiguous
//     rows, so the softmax and the sum over k are per-receiver passes with no atomics.
//   * The rotations, the grid activation, the attention head and the sum over k are
//     per-edge or per-receiver kernels, one thread a channel, the stacks in registers,
//     loops unrolled at compile time for L, M.
//   * P recomputes the forward, then runs the transposes: the attention head per receiver,
//     the transposed products per edge, the weight gradients as products over all live
//     edges (a split of the rows sized from the tile count into partial tiles, summed in a
//     fixed order), and gx through the gather's transpose: a per-sender list of (i, k)
//     built on the card by a counting sort per molecule, walked in order by a sender-owned
//     kernel. No float atomics: P gives the same bits on every run.
// The products are fp32-accurate (3xTF32; the tolerance is 2e-5 of the output's scale), the
// rest plain fp32 FMA.
// The bf16 mode (eqv2_fwd_bf16 / eqv2_bwd_bf16; the TPU kernels' mxu_bf16, the model's
// compute_dtype bfloat16) rounds to bf16 where `_attn_pipeline` and `_attn_pipeline_bwd`
// pass a value through `_mdot(., ., True)`, and nowhere else:
//   * both operands of the radial product, of every SO(2) product, of their transposes and
//     of every weight gradient, on the engine's bf16 operand mode (bf16 wgmma, fp32 sums):
//     the weights rounded once a launch in its prep; every other operand written as bf16,
//     nearest-even, by the kernel that makes it and read by the products alone (xe's live
//     rows: eqv2_rows16_kernel; the scaled stack: the rotation; conv 2's input: the grid
//     activation; in P the values' and alpha scalars' cotangents: the attention backward;
//     the hidden rows' and gates' cotangents: the grid backward; the radial scale's
//     cotangent: the rotations' backward). A buffer a fp32 stage also reads keeps its fp32
//     copy (the hidden rows, the extra columns, rad and its cotangent, the stack's cotangent).
//     These are the values a fragment load would round, so the products differ from rounding
//     fp32 operands at every load only in the fp32 summation order;
//   * the sender rows x_j, which the TPU kernel gathers with a one-hot product: rounded
//     where they are gathered (the rotation kernels); the receiver's own rows x_i are only
//     broadcast there and stay fp32;
//   * gx, the gather's transpose (the one-hot product's transpose): each edge's rotated-back
//     source cotangent rounded before the sum over the sender's edges; gxi is not.
// The per-head reductions (the TPU kernel's 0/1 expander products, `_mdot(., ., False)`),
// b_rad, the LayerNorm and alpha vectors and their gradients, the grid activation, the
// softmax, the rotations and every sum stay fp32.

#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>
#include <vector>

#include "so2_common.cuh"

namespace {

constexpr int VPL = 4;  // alpha channels a lane holds (VA <= 32 VPL)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Dims {
  int B, A, K, C, CO, EC, NH, VA, KW, P, L, M;
  long long E;  // edge slots B*A*K (the live edges are a prefix of them)
  int S, ST, C2, FLAT, HID, RADW, NX, EXTRA, W1N, n0, VC;
  int span_p(int m) const {
    int off = L + 1;
    for (int q = 1; q < m; ++q) off += 2 * (L + 1 - q);
    return off;
  }
  int span_m(int m) const { return span_p(m) + (L + 1 - m); }
  int nl(int m) const { return L + 1 - m; }
  // weight pointers: w_rad, b_rad, w1, fc1_m1..M, w2, fc2_m1..M, ln_scale, ln_bias, alpha_dot
  int i_fc1(int m) const { return 2 + m; }
  int i_w2() const { return 3 + M; }
  int i_fc2(int m) const { return 3 + M + m; }
  int i_lns() const { return 4 + 2 * M; }
};

Dims make_dims(int B, int A, int K, int C, int CO, int EC, int NH, int VA, int KW, int P, int L,
               int M) {
  Dims D{B, A, K, C, CO, EC, NH, VA, KW, P, L, M};
  D.E = (long long)B * A * K;
  D.S = (L + 1) * (L + 1);
  D.ST = s_trunc(L, M);
  D.C2 = 2 * C;
  D.FLAT = D.ST * D.C2;
  D.HID = D.ST * CO;
  D.n0 = L + 1;
  D.RADW = D.n0 * D.C2;
  D.NX = NH * VA;
  D.EXTRA = D.NX + CO;
  D.W1N = D.n0 * CO + D.EXTRA;
  D.VC = NH > 0 ? CO / NH : 0;
  return D;
}

// ---------------------------------------------------------------------------
// the live-edge list and the per-sender lists
// ---------------------------------------------------------------------------

__global__ void eqv2_flags_kernel(const float* __restrict__ maskf, int* __restrict__ flags,
                                  long long n) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p < n) flags[p] = maskf[p] > 0.5f ? 1 : 0;
}

// per molecule (one block, thread j a sender): the live slots p with idx[p] == j, in slot
// order, at slist[sbeg[b*A+j] ...] (scnt of them): a counting sort, no atomics
__global__ void eqv2_sender_list_kernel(const int* __restrict__ idx,
                                        const int* __restrict__ flags, int* __restrict__ slist,
                                        int* __restrict__ sbeg, int* __restrict__ scnt, int A,
                                        int K) {
  extern __shared__ int offs[];
  const int b = blockIdx.x, j = threadIdx.x;
  const long long base = (long long)b * A * K, n = (long long)A * K;
  int cnt = 0;
  if (j < A)
    for (long long p = base; p < base + n; ++p) cnt += (flags[p] && idx[p] == j) ? 1 : 0;
  offs[j] = cnt;
  __syncthreads();
  if (j == 0) {
    int run = 0;
    for (int q = 0; q < A; ++q) {
      const int c = offs[q];
      offs[q] = run;
      run += c;
    }
  }
  __syncthreads();
  if (j >= A) return;
  const long long start = base + offs[j];
  sbeg[b * A + j] = (int)start;
  scnt[b * A + j] = cnt;
  int w = 0;
  for (long long p = base; p < base + n; ++p)
    if (flags[p] && idx[p] == j) slist[start + w++] = (int)p;
}

// ---------------------------------------------------------------------------
// per-receiver and per-edge stages; L and M are compile-time so the stacks stay in registers
// ---------------------------------------------------------------------------

// the bf16 mode's radial-product rows: xe16[e] = xe[eidx[e]] rounded to bf16, in the live
// order, so that the product and its weight gradient read them by TMA (8 values a thread)
__global__ void __launch_bounds__(256) eqv2_rows16_kernel(const float* __restrict__ xe,
                                                          const int* __restrict__ eidx,
                                                          const int* __restrict__ n_rows,
                                                          uint16_t* __restrict__ xe16, int EC) {
  const int per = EC / 8;
  const long long n = (long long)*n_rows * per;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < n;
       u += (long long)gridDim.x * blockDim.x) {
    const long long e = u / per;
    const int c = (int)(u - e * per) * 8;
    const float4* src = reinterpret_cast<const float4*>(xe + (long long)eidx[e] * EC + c);
    const float4 p = src[0], q = src[1];
    const auto two = [](float lo, float hi) {
      return (uint32_t)bf16_rn(lo) | ((uint32_t)bf16_rn(hi) << 16);
    };
    *reinterpret_cast<uint4*>(xe16 + e * EC + c) =
        make_uint4(two(p.x, p.y), two(p.z, p.w), two(q.x, q.y), two(q.z, q.w));
  }
}

// flat[e] = [src | tgt] per m-major row, each scaled by rad[e] of its l: [E, S_t * 2C];
// R (the bf16 mode): the sender rows rounded to bf16, flat written as bf16 (conv 1's operand)
template <int L, int M, bool R>
__global__ void __launch_bounds__(RT) eqv2_rotate_kernel(
    const float* __restrict__ x, const float* __restrict__ xi, const int* __restrict__ idx,
    const float* __restrict__ d, const float* __restrict__ rad, const int* __restrict__ rs,
    const int* __restrict__ eidx, void* __restrict__ flat, int A, int C, int KW) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  const int bi = blockIdx.x, b = bi / A;
  const int e_lo = rs[bi], e_hi = rs[bi + 1];
  if (e_lo == e_hi) return;
  const int C2 = 2 * C, FL = ST * C2, RW = (L + 1) * C2;
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    const int cc = act ? c : 0;
    float xr[S];
#pragma unroll
    for (int s = 0; s < S; ++s) xr[s] = xi[((long long)bi * S + s) * C + cc];
    for (int e = e_lo; e < e_hi; ++e) {
      const int p = eidx[e];
      const float* xj = x + ((long long)b * A + idx[p]) * S * C + cc;
      const float* dp = d + (long long)p * KW;
      const float* rp = rad + (long long)e * RW;
      float xs[S];
#pragma unroll
      for (int s = 0; s < S; ++s) xs[s] = xj[(long long)s * C];
      if constexpr (R)  // the bf16 mode's gathered sender rows
#pragma unroll
        for (int s = 0; s < S; ++s) xs[s] = round_bf16(xs[s]);
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        const int l = row_l(L, M, r), base = row_base(L, M, r);
        float as = 0.f, at = 0.f;
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          const float dv = __ldg(dp + base + col);
          as = fmaf(dv, xs[l * l + col], as);
          at = fmaf(dv, xr[l * l + col], at);
        }
        if (act) {
          put<R>(flat, (long long)e * FL + r * C2 + c, as * rp[l * C2 + c]);
          put<R>(flat, (long long)e * FL + r * C2 + C + c, at * rp[l * C2 + C + c]);
        }
      }
    }
  }
}

// the separable S2 activation of each live edge's hidden rows: act row 0 = silu(gate),
// rows 1.. = from_g silu(to_g hid) (the grid's row 0 output is dropped); B16 (the bf16
// mode): act written as bf16 (conv 2's operand)
template <int L, int M, bool B16>
__global__ void __launch_bounds__(RT) eqv2_grid_kernel(
    const float* __restrict__ hid, const float* __restrict__ gate, const float* __restrict__ tog,
    const float* __restrict__ fromg, void* __restrict__ act, const int* __restrict__ n_rows,
    int CO, int EXTRA, int P) {
  constexpr int ST = s_trunc(L, M);
  extern __shared__ float tab[];
  stage_grid(tog, fromg, P, ST, tab);
  const int n = *n_rows, HID = ST * CO;
  for (int e = blockIdx.x; e < n; e += gridDim.x) {
    for (int c = threadIdx.x; c < CO; c += blockDim.x) {
      float m[ST], m2[ST];
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        m[r] = hid[(long long)e * HID + r * CO + c];
        m2[r] = 0.f;
      }
      grid_silu<ST>(tab, P, m, m2);  // m2[0] unused: row 0 is silu(gate)
      put<B16>(act, (long long)e * HID + c, silu(gate[(long long)e * EXTRA + c]));
#pragma unroll
      for (int r = 1; r < ST; ++r) put<B16>(act, (long long)e * HID + r * CO + c, m2[r]);
    }
  }
}

// P: the grid activation's transpose, from its cotangent g (rows 1..) into gout (g itself,
// in place, or, B16, a bf16 copy: conv 1's operand): ghid = to_g^T (silu'(z) from_g^T g)
// with z recomputed from hid; the gate's cotangent ggate (bf16 where B16) from row 0
template <int L, int M, bool B16>
__global__ void __launch_bounds__(RT) eqv2_grid_bwd_kernel(
    const float* __restrict__ hid, const float* __restrict__ gate, const float* __restrict__ tog,
    const float* __restrict__ fromg, const float* g, void* gout, void* __restrict__ ggate,
    const int* __restrict__ n_rows, int CO, int EXTRA, int P) {
  constexpr int ST = s_trunc(L, M);
  extern __shared__ float tab[];
  stage_grid(tog, fromg, P, ST, tab);
  const int n = *n_rows, HID = ST * CO;
  for (int e = blockIdx.x; e < n; e += gridDim.x) {
    for (int c = threadIdx.x; c < CO; c += blockDim.x) {
      float m[ST], gm2[ST], gm[ST];
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        m[r] = hid[(long long)e * HID + r * CO + c];
        gm2[r] = r ? g[(long long)e * HID + r * CO + c] : 0.f;
        gm[r] = 0.f;
      }
      grid_silu_bwd<ST>(tab, P, m, gm2, gm);
      const long long ge = (long long)e * EXTRA + c;
      put<B16>(ggate, ge, g[(long long)e * HID + c] * dsilu(gate[ge]));
#pragma unroll
      for (int r = 0; r < ST; ++r) put<B16>(gout, (long long)e * HID + r * CO + c, gm[r]);
    }
  }
}

// one warp: the per-head LayerNorm of the alpha scalars a[0..VA) of one edge and head,
// held as VPL values a lane (v = lane + 32 q); returns 1/sqrt(var + eps), leaves the
// centred values in cen
__device__ __forceinline__ float head_norm(const float* __restrict__ a, int VA, int lane,
                                           float cen[VPL]) {
  float s = 0.f;
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
    const int v = lane + 32 * q;
    cen[q] = v < VA ? a[v] : 0.f;
    s += cen[q];
  }
  const float mu = warp_sum(s) / (float)VA;
  float s2 = 0.f;
#pragma unroll
  for (int q = 0; q < VPL; ++q) {
    const int v = lane + 32 * q;
    cen[q] = v < VA ? cen[q] - mu : 0.f;
    s2 = fmaf(cen[q], cen[q], s2);
  }
  return 1.f / sqrtf(warp_sum(s2) / (float)VA + 1e-6f);
}

// the logits of the receiver's live edges, then their softmax over the edges per head:
// al[(e - e_lo) * NH + h] (before the keep mask)
__device__ void receiver_softmax(const float* __restrict__ ext, const float* __restrict__ lns,
                                 const float* __restrict__ lnb, const float* __restrict__ adot,
                                 int e_lo, int e_hi, int NH, int VA, int EXTRA, float* al) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ne = e_hi - e_lo;
  for (int t = warp; t < ne * NH; t += nw) {
    const int e = e_lo + t / NH, h = t - (t / NH) * NH;
    const float* a = ext + (long long)e * EXTRA + h * VA;
    float cen[VPL];
    const float inv = head_norm(a, VA, lane, cen);
    float lp = 0.f;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int v = lane + 32 * q;
      if (v < VA) {
        const int hv = h * VA + v;
        lp = fmaf(silu(fmaf(cen[q] * inv, lns[hv], lnb[hv])), adot[hv], lp);
      }
    }
    lp = warp_sum(lp);
    if (lane == 0) al[t] = lp;
  }
  __syncthreads();
  for (int h = threadIdx.x; h < NH; h += blockDim.x) {
    float mx = __int_as_float(0xff800000);  // -inf
    for (int q = 0; q < ne; ++q) mx = fmaxf(mx, al[q * NH + h]);
    float den = 0.f;
    for (int q = 0; q < ne; ++q) {
      const float ex = expf(al[q * NH + h] - mx);
      al[q * NH + h] = ex;
      den += ex;
    }
    den = fmaxf(den, 1e-20f);
    for (int q = 0; q < ne; ++q) al[q * NH + h] = al[q * NH + h] / den;
  }
  __syncthreads();
}

// O's last stage, per receiver: the attention weights of its live edges, the values
// weighted per head, rotated back with D^T and summed over k in order
template <int L, int M>
__global__ void __launch_bounds__(RT) eqv2_attn_out_kernel(
    const float* __restrict__ val, const float* __restrict__ ext, const float* __restrict__ d,
    const float* __restrict__ dropk, const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ adot, const int* __restrict__ rs, const int* __restrict__ eidx,
    float* __restrict__ agg, int CO, int NH, int VA, int EXTRA, int KW) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  extern __shared__ float al[];
  const int bi = blockIdx.x;
  const int e_lo = rs[bi], e_hi = rs[bi + 1];
  receiver_softmax(ext, lns, lnb, adot, e_lo, e_hi, NH, VA, EXTRA, al);
  const int HID = ST * CO, VC = CO / NH;
  for (int c = threadIdx.x; c < CO; c += blockDim.x) {
    const int h = c / VC;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    for (int e = e_lo; e < e_hi; ++e) {
      const int p = eidx[e];
      const float a = al[(e - e_lo) * NH + h] * dropk[(long long)p * NH + h];
      const float* dp = d + (long long)p * KW;
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        const int l = row_l(L, M, r), base = row_base(L, M, r);
        const float v = val[(long long)e * HID + r * CO + c] * a;
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          acc[l * l + col] = fmaf(__ldg(dp + base + col), v, acc[l * l + col]);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) agg[((long long)bi * S + s) * CO + c] = acc[s];
  }
}

// P's attention stage, per receiver: from agg's cotangent g, the values' cotangent gval,
// the alpha scalars' cotangent (gext's first NH VA columns) through the softmax, the
// per-head LayerNorm and silu, and each edge's share of the LN scale / bias and alpha_dot
// gradients (lng: [g_lns | g_lnb | g_adot] per edge, summed over the edges later); B16 (the
// bf16 mode): gval and gext written as bf16 (conv 2's and conv 1's operands)
template <int L, int M, bool B16>
__global__ void __launch_bounds__(RT) eqv2_attn_bwd_kernel(
    const float* __restrict__ val, const float* __restrict__ ext, const float* __restrict__ d,
    const float* __restrict__ dropk, const float* __restrict__ lns, const float* __restrict__ lnb,
    const float* __restrict__ adot, const float* __restrict__ g, const int* __restrict__ rs,
    const int* __restrict__ eidx, void* __restrict__ gval, void* __restrict__ gext,
    float* __restrict__ lng, int K, int CO, int NH, int VA, int EXTRA, int KW) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  extern __shared__ float sm[];
  float* al = sm;             // [K][NH] softmax
  float* ga = al + K * NH;    // [K][NH] its cotangent, then the logits'
  float* gae = ga + K * NH;   // [K][CO] the per-channel attention weights' cotangent
  const int bi = blockIdx.x;
  const int e_lo = rs[bi], e_hi = rs[bi + 1], ne = e_hi - e_lo;
  if (ne == 0) return;
  receiver_softmax(ext, lns, lnb, adot, e_lo, e_hi, NH, VA, EXTRA, al);
  const int HID = ST * CO, VC = CO / NH, NX = NH * VA;
  for (int c = threadIdx.x; c < CO; c += blockDim.x) {
    const int h = c / VC;
    float gi[S];
#pragma unroll
    for (int s = 0; s < S; ++s) gi[s] = g[((long long)bi * S + s) * CO + c];
    for (int e = e_lo; e < e_hi; ++e) {
      const int p = eidx[e];
      const float a = al[(e - e_lo) * NH + h] * dropk[(long long)p * NH + h];
      const float* dp = d + (long long)p * KW;
      float gsum = 0.f;
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        const int l = row_l(L, M, r), base = row_base(L, M, r);
        float t = 0.f;
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          t = fmaf(__ldg(dp + base + col), gi[l * l + col], t);
        }
        put<B16>(gval, (long long)e * HID + r * CO + c, t * a);
        gsum = fmaf(t, val[(long long)e * HID + r * CO + c], gsum);
      }
      gae[(e - e_lo) * CO + c] = gsum;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ne * NH; t += blockDim.x) {
    const int q = t / NH, h = t - q * NH;
    float s = 0.f;
    for (int v = 0; v < VC; ++v) s += gae[q * CO + h * VC + v];
    ga[t] = s * dropk[(long long)eidx[e_lo + q] * NH + h];
  }
  __syncthreads();
  for (int h = threadIdx.x; h < NH; h += blockDim.x) {
    float dot = 0.f;
    for (int q = 0; q < ne; ++q) dot = fmaf(al[q * NH + h], ga[q * NH + h], dot);
    for (int q = 0; q < ne; ++q) ga[q * NH + h] = al[q * NH + h] * (ga[q * NH + h] - dot);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int t = warp; t < ne * NH; t += nw) {
    const int e = e_lo + t / NH, h = t - (t / NH) * NH;
    const float gz = ga[t];
    float cen[VPL], xh[VPL], gxh[VPL];
    const float inv = head_norm(ext + (long long)e * EXTRA + h * VA, VA, lane, cen);
    float m1 = 0.f, m2 = 0.f;
    float* le = lng + (long long)e * 3 * NX;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int v = lane + 32 * q;
      xh[q] = cen[q] * inv;
      gxh[q] = 0.f;
      if (v < VA) {
        const int hv = h * VA + v;
        const float ln = fmaf(xh[q], lns[hv], lnb[hv]);
        const float gln = gz * adot[hv] * dsilu(ln);
        le[hv] = gln * xh[q];
        le[NX + hv] = gln;
        le[2 * NX + hv] = gz * silu(ln);
        gxh[q] = gln * lns[hv];
      }
      m1 += gxh[q];
      m2 = fmaf(gxh[q], xh[q], m2);
    }
    m1 = warp_sum(m1) / (float)VA;
    m2 = warp_sum(m2) / (float)VA;
#pragma unroll
    for (int q = 0; q < VPL; ++q) {
      const int v = lane + 32 * q;
      if (v < VA) put<B16>(gext, (long long)e * EXTRA + h * VA + v, inv * (gxh[q] - m1 - xh[q] * m2));
    }
  }
}

// P: the radial scale's and the rotations' transposes, per receiver: from the cotangent
// of the scaled stack (gflat), in place: rad becomes the radial scale's cotangent (summed
// over the rows of each l) and gflat's source half the source stack's (gflat * rad); the
// target halves, rotated back and summed over k in order, give gxi; R (the bf16 mode): the
// sender rows rounded to bf16, and the radial scale's cotangent also written as bf16 to rad16
// (the radial product's transpose and weight gradient read it; b_rad's sum reads rad)
template <int L, int M, bool R>
__global__ void __launch_bounds__(RT) eqv2_rot_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ xi, const int* __restrict__ idx,
    const float* __restrict__ d, float* __restrict__ rad, float* __restrict__ gflat,
    const int* __restrict__ rs, const int* __restrict__ eidx, float* __restrict__ gxi,
    uint16_t* __restrict__ rad16, int A, int C, int KW) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  const int bi = blockIdx.x, b = bi / A;
  const int e_lo = rs[bi], e_hi = rs[bi + 1];
  const int C2 = 2 * C, FL = ST * C2, RW = (L + 1) * C2;
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    const int cc = act ? c : 0;
    float xr[S], acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      xr[s] = xi[((long long)bi * S + s) * C + cc];
      acc[s] = 0.f;
    }
    for (int e = e_lo; e < e_hi; ++e) {
      const int p = eidx[e];
      const float* xj = x + ((long long)b * A + idx[p]) * S * C + cc;
      const float* dp = d + (long long)p * KW;
      float* rp = rad + (long long)e * RW;
      float* gf = gflat + (long long)e * FL;
      float xs[S], rsc[L + 1], rtc[L + 1], gs[L + 1], gt[L + 1];
#pragma unroll
      for (int s = 0; s < S; ++s) xs[s] = xj[(long long)s * C];
      if constexpr (R)  // the stack recomputed from the rounded sender rows, as the forward's
#pragma unroll
        for (int s = 0; s < S; ++s) xs[s] = round_bf16(xs[s]);
#pragma unroll
      for (int l = 0; l <= L; ++l) {
        rsc[l] = rp[l * C2 + cc];
        rtc[l] = rp[l * C2 + C + cc];
        gs[l] = gt[l] = 0.f;
      }
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        const int l = row_l(L, M, r), base = row_base(L, M, r);
        float dv[2 * L + 1];
        float as = 0.f, at = 0.f;
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          dv[col] = __ldg(dp + base + col);
          as = fmaf(dv[col], xs[l * l + col], as);
          at = fmaf(dv[col], xr[l * l + col], at);
        }
        const float gfs = gf[r * C2 + cc], gft = gf[r * C2 + C + cc];
        gs[l] = fmaf(gfs, as, gs[l]);
        gt[l] = fmaf(gft, at, gt[l]);
        const float gtt = gft * rtc[l];
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          acc[l * l + col] = fmaf(dv[col], gtt, acc[l * l + col]);
        }
        if (act) gf[r * C2 + c] = gfs * rsc[l];
      }
      if (act)
#pragma unroll
        for (int l = 0; l <= L; ++l) {
          rp[l * C2 + c] = gs[l];
          rp[l * C2 + C + c] = gt[l];
          if constexpr (R) {
            rad16[(long long)e * RW + l * C2 + c] = bf16_rn(gs[l]);
            rad16[(long long)e * RW + l * C2 + C + c] = bf16_rn(gt[l]);
          }
        }
    }
    if (act)
#pragma unroll
      for (int s = 0; s < S; ++s) gxi[((long long)bi * S + s) * C + c] = acc[s];
  }
}

// acc[l^2 + col] += sum over the m-major rows r of degree l of D[r, col] v[r * ld], one
// channel's rotate-back of an m-major stack v
template <int L, int M>
__device__ __forceinline__ void rotate_back_add(float (&acc)[(L + 1) * (L + 1)],
                                                const float* __restrict__ v, int ld,
                                                const float* __restrict__ dp) {
  constexpr int ST = s_trunc(L, M);
#pragma unroll
  for (int r = 0; r < ST; ++r) {
    const int l = row_l(L, M, r), base = row_base(L, M, r);
    const float vr = v[r * ld];
#pragma unroll
    for (int col = 0; col < 2 * L + 1; ++col) {
      if (col >= 2 * l + 1) break;
      acc[l * l + col] = fmaf(__ldg(dp + base + col), vr, acc[l * l + col]);
    }
  }
}

// P's gx: per (molecule b, atom j), the rotation transposes of the source stacks'
// cotangents of the edges (i, k) with idx = j, in slot order; R (the bf16 mode): each edge's
// rotated-back cotangent rounded to bf16 before it is added
template <int L, int M, bool R>
__global__ void __launch_bounds__(RT) eqv2_gx_kernel(
    const float* __restrict__ gflat, const float* __restrict__ d, const int* __restrict__ slist,
    const int* __restrict__ sbeg, const int* __restrict__ scnt, const int* __restrict__ pos,
    float* __restrict__ gx, int C, int KW) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  const int bj = blockIdx.x;
  const int FL = ST * 2 * C;
  const int lo = sbeg[bj], n = scnt[bj];
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    for (int q = 0; q < n; ++q) {
      const int p = slist[lo + q];
      const long long e = pos[p];
      const float* dp = d + (long long)p * KW;
      if constexpr (R) {
        float t[S];
#pragma unroll
        for (int s = 0; s < S; ++s) t[s] = 0.f;
        rotate_back_add<L, M>(t, gflat + e * FL + c, 2 * C, dp);
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] += round_bf16(t[s]);
      } else {
        rotate_back_add<L, M>(acc, gflat + e * FL + c, 2 * C, dp);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) gx[((long long)bj * S + s) * C + c] = acc[s];
  }
}

// ---------------------------------------------------------------------------
// host side: scratch and the problem lists of each stage
// ---------------------------------------------------------------------------

// the scratch of a launch. float32 mode: FLAT holds the scaled stack, then (P) its cotangent
// GFLAT; GACT is conv 2's transpose, then in place the hidden rows' cotangent. bf16 mode: the
// products' operands are bf16 copies written by the kernels that make them (XE16, FLAT16,
// ACT16; P: GVAL16, GACT16, GEXT16, GRAD16) and have no float32 copy where no other stage
// reads them; GFLAT overlays what conv 1's transposes leave dead.
struct Bufs {
  float *RAD, *FLAT, *HID, *EXT, *ACT, *VAL, *GVAL, *GACT, *GEXT, *LNG, *GFLAT;
  uint16_t *XE16, *FLAT16, *ACT16, *GVAL16, *GACT16, *GEXT16, *GRAD16;
  int *flags, *eidx, *pos, *rs, *n_rows, *slist, *sbeg, *scnt;
  Engine en;
};

// the weights' floats: the engine's TF32 halves take twice this
long long weight_floats(const Dims& D) {
  long long n = (long long)D.EC * D.RADW + D.RADW + (long long)D.RADW * D.W1N +
                (long long)D.n0 * D.CO * D.n0 * D.CO + 3LL * D.NX;
  for (int m = 1; m <= D.M; ++m)
    n += 2LL * D.nl(m) * D.C2 * D.nl(m) * D.CO + 2LL * D.nl(m) * D.CO * D.nl(m) * D.CO;
  return n;
}

// partial floats of the weight-gradient launches (the column sums: b_rad, LayerNorm, alpha)
long long part_floats(const Dims& D) { return part_bound(D.RADW + 3LL * D.NX); }

// the bf16 mode's floats an edge slot: the buffers conv 1's transposes leave dead (FLAT16,
// ACT16, HID, EXT, VAL; P: GVAL16, GACT), which GFLAT overlays in P
long long dead16(const Dims& D, bool bwd) {
  const long long f = D.FLAT / 2 + D.HID / 2 + 2LL * D.HID + D.EXTRA;
  return bwd ? std::max(f + D.HID / 2 + D.HID, (long long)D.FLAT) : f;
}
long long slot16(const Dims& D, bool bwd) {
  const long long keep = D.RADW + D.EC / 2;  // RAD, XE16
  if (!bwd) return keep + dead16(D, false);
  return keep + D.HID / 2 + D.EXTRA / 2 + D.RADW / 2 + 3LL * D.NX + dead16(D, true);
}

// forward: RAD, FLAT (the values overwrite it), HID, EXT, ACT and the weights' halves;
// backward adds VAL, GVAL, GACT, GEXT, LNG and the partial tiles; the bf16 mode: slot16 an
// edge slot and one bf16 copy of the weights
long long scratch_floats(const Dims& D, bool bwd, bool b16) {
  const long long fwd = D.RADW + D.FLAT + 2LL * D.HID + D.EXTRA;
  const long long prep = b16 ? weight_floats(D) / 2 : 2 * weight_floats(D);
  const long long part = bwd ? part_floats(D) : 0;
  if (b16) return D.E * slot16(D, bwd) + prep + part;
  if (!bwd) return D.E * fwd + prep;
  return D.E * (fwd + 3LL * D.HID + D.EXTRA + 3LL * D.NX) + prep + part;
}

long long scratch_ints(int B, int A, int K) {
  const long long E = (long long)B * A * K;
  return 4 * E + 3LL * B * A + 2;
}

Bufs carve(const Dims& D, float* f, int* iw, bool bwd, bool b16) {
  Bufs b{};
  auto take = [&](long long per) {
    float* p = f;
    f += D.E * per;
    return p;
  };
  auto take16 = [&](long long cols) { return reinterpret_cast<uint16_t*>(take(cols / 2)); };
  if (b16) {
    b.RAD = take(D.RADW);
    b.XE16 = take16(D.EC);
    if (bwd) {
      b.GACT16 = take16(D.HID);
      b.GEXT16 = take16(D.EXTRA);
      b.GRAD16 = take16(D.RADW);
      b.LNG = take(3LL * D.NX);
    }
    float* dead = f;
    b.FLAT16 = take16(D.FLAT);
    b.ACT16 = take16(D.HID);
    b.HID = take(D.HID);
    b.EXT = take(D.EXTRA);
    b.VAL = take(D.HID);
    if (bwd) {
      b.GVAL16 = take16(D.HID);
      b.GACT = take(D.HID);
      b.GFLAT = dead;
    }
    f = dead + D.E * dead16(D, bwd);
  } else {
    b.RAD = take(D.RADW);
    b.FLAT = b.GFLAT = take(D.FLAT);
    b.HID = take(D.HID);
    b.EXT = take(D.EXTRA);
    b.ACT = take(D.HID);
    b.VAL = b.FLAT;
    if (bwd) {
      b.VAL = take(D.HID);
      b.GVAL = take(D.HID);
      b.GACT = take(D.HID);
      b.GEXT = take(D.EXTRA);
      b.LNG = take(3LL * D.NX);
    }
  }
  b.flags = iw;
  b.eidx = iw + D.E;
  b.pos = iw + 2 * D.E;
  b.slist = iw + 3 * D.E;
  b.rs = iw + 4 * D.E;
  b.n_rows = b.rs + (long long)D.B * D.A + 1;
  b.sbeg = b.n_rows + 1;
  b.scnt = b.sbeg + (long long)D.B * D.A;
  const long long prep = b16 ? weight_floats(D) / 2 : 2 * weight_floats(D);
  b.en = Engine{D.E, b.n_rows, b.eidx, f, prep, f + prep, bwd ? part_floats(D) : 0, 0, b16};
  return b;
}

size_t grid_smem(const Dims& D) { return sizeof(float) * 2 * (size_t)D.P * D.ST; }
size_t attn_smem(const Dims& D, bool bwd) {
  return sizeof(float) * (size_t)D.K * (bwd ? 2 * D.NH + D.CO : D.NH);
}
unsigned edge_blocks(const Dims& D) { return (unsigned)std::min<long long>(D.E, 2048); }

template <typename F>
cudaError_t allow_smem(F kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// a segment's A operand: float32 values or (T = uint16_t, the bf16 mode) bf16 ones
template <typename T>
const float* av(const T* p) {
  return reinterpret_cast<const float*>(p);
}

// the SO(2) conv of a flat [E, S_t cin] stack (m-major rows; T its element) into out
// [E, S_t CO]: m=0 rows times w0's first (L+1) CO columns (and its extra columns into
// `extra`), per m the packed (wr | wi): out(+m) = f(+m) wr - f(-m) wi, out(-m) = f(-m) wr +
// f(+m) wi
template <typename T>
void so2_conv(const Dims& D, std::vector<NNProb>& probs, const T* in, int cin, const float* w0,
              int w0n, const float* const* wm, float* out, float* extra) {
  const int ld_in = D.ST * cin, n0co = D.n0 * D.CO;
  probs.push_back(prob({seg(av(in), ld_in, w0, w0n, D.n0 * cin)}, n0co, EPI_STORE, out, D.HID));
  if (extra)
    probs.push_back(prob({seg(av(in), ld_in, w0 + n0co, w0n, D.n0 * cin)}, w0n - n0co,
                         EPI_STORE, extra, w0n - n0co));
  for (int m = 1; m <= D.M; ++m) {
    const int nlc = D.nl(m) * cin, nlco = D.nl(m) * D.CO, ldb = 2 * nlco;
    const float *fp = av(in + D.span_p(m) * cin), *fm = av(in + D.span_m(m) * cin);
    const float *wr = wm[m - 1], *wi = wm[m - 1] + nlco;
    probs.push_back(prob({seg(fp, ld_in, wr, ldb, nlc), seg(fm, ld_in, wi, ldb, nlc, false, -1.f)},
                         nlco, EPI_STORE, out + D.span_p(m) * D.CO, D.HID));
    probs.push_back(prob({seg(fm, ld_in, wr, ldb, nlc), seg(fp, ld_in, wi, ldb, nlc)}, nlco,
                         EPI_STORE, out + D.span_m(m) * D.CO, D.HID));
  }
}

// its transpose: gin [E, S_t cin] from gout [E, S_t CO] (and gextra for w0's extra columns)
template <typename T>
void so2_conv_t(const Dims& D, std::vector<NNProb>& probs, const T* gout, const T* gextra, int cin,
                const float* w0, int w0n, const float* const* wm, float* gin) {
  const int ld_in = D.ST * cin, n0co = D.n0 * D.CO;
  NNProb p0 =
      prob({seg(av(gout), D.HID, w0, w0n, n0co, true)}, D.n0 * cin, EPI_STORE, gin, ld_in);
  if (gextra) p0.seg[p0.nseg++] = seg(av(gextra), w0n - n0co, w0 + n0co, w0n, w0n - n0co, true);
  probs.push_back(p0);
  for (int m = 1; m <= D.M; ++m) {
    const int nlc = D.nl(m) * cin, nlco = D.nl(m) * D.CO, ldb = 2 * nlco;
    const float *gp = av(gout + D.span_p(m) * D.CO), *gm = av(gout + D.span_m(m) * D.CO);
    const float *wr = wm[m - 1], *wi = wm[m - 1] + nlco;
    probs.push_back(prob({seg(gp, D.HID, wr, ldb, nlco, true), seg(gm, D.HID, wi, ldb, nlco, true)},
                         nlc, EPI_STORE, gin + D.span_p(m) * cin, ld_in));
    probs.push_back(prob({seg(gm, D.HID, wr, ldb, nlco, true),
                          seg(gp, D.HID, wi, ldb, nlco, true, -1.f)},
                         nlc, EPI_STORE, gin + D.span_m(m) * cin, ld_in));
  }
}

// its weight gradients: gw0 [(L+1) cin, w0n] and per m gwm [n_l cin, 2 n_l CO]
template <typename T>
void so2_conv_w(const Dims& D, std::vector<TNProb>& probs, const T* in, const T* gout,
                const T* gextra, int cin, int w0n, float* gw0, float* const* gwm) {
  const int ld_in = D.ST * cin, n0co = D.n0 * D.CO;
  probs.push_back(tprob({TSeg{av(in), av(gout), ld_in, D.HID, 1.f}}, A_ROWS, D.n0 * cin, n0co,
                        gw0, w0n));
  if (gextra)
    probs.push_back(tprob({TSeg{av(in), av(gextra), ld_in, w0n - n0co, 1.f}}, A_ROWS,
                          D.n0 * cin, w0n - n0co, gw0 + n0co, w0n));
  for (int m = 1; m <= D.M; ++m) {
    const int nlc = D.nl(m) * cin, nlco = D.nl(m) * D.CO;
    const float *fp = av(in + D.span_p(m) * cin), *fm = av(in + D.span_m(m) * cin);
    const float *gp = av(gout + D.span_p(m) * D.CO), *gm = av(gout + D.span_m(m) * D.CO);
    probs.push_back(tprob({TSeg{fp, gp, ld_in, D.HID, 1.f}, TSeg{fm, gm, ld_in, D.HID, 1.f}},
                          A_ROWS, nlc, nlco, gwm[m - 1], 2 * nlco));
    probs.push_back(tprob({TSeg{fp, gm, ld_in, D.HID, 1.f}, TSeg{fm, gp, ld_in, D.HID, -1.f}},
                          A_ROWS, nlc, nlco, gwm[m - 1] + nlco, 2 * nlco));
  }
}

// return the error of a launch or a stage (the argument may hold template commas)
#define CK(...)                                   \
  do {                                            \
    const cudaError_t err_ = (__VA_ARGS__);       \
    if (err_ != cudaSuccess) return err_;         \
  } while (0)

// the bf16 mode's element of the products' operands (uint16_t), or float
template <bool B16>
using Op = std::conditional_t<B16, uint16_t, float>;

// the buffer a product reads: the bf16 copy in the bf16 mode, else the float32 one
template <bool B16>
Op<B16>* pick(float* f, uint16_t* h) {
  if constexpr (B16)
    return h;
  else
    return f;
}

// the live-edge list, the scaled stacks, conv 1, the grid activation and conv 2 (into VAL)
template <int L, int M, bool B16>
cudaError_t forward_stages(const Dims& D, const float* x, const float* xi, const int* idx,
                           const float* d, const float* xe, const float* maskf,
                           const float* const* w, const float* tog, const float* fromg,
                           const Bufs& bf, cudaStream_t st) {
  eqv2_flags_kernel<<<(unsigned)((D.E + 255) / 256), 256, 0, st>>>(maskf, bf.flags, D.E);
  CK(cudaGetLastError());
  CK(live_rows(bf.flags, bf.eidx, bf.pos, bf.rs, bf.n_rows, D.E, D.K, st));
  NNProb prad;
  if constexpr (B16) {  // the live rows of xe as bf16, in order
    eqv2_rows16_kernel<<<edge_blocks(D), 256, 0, st>>>(xe, bf.eidx, bf.n_rows, bf.XE16, D.EC);
    CK(cudaGetLastError());
    prad = prob({seg(av(bf.XE16), D.EC, w[0], D.RADW, D.EC)}, D.RADW, EPI_GATES, bf.RAD, D.RADW);
  } else {
    prad = prob({seg(xe, D.EC, w[0], D.RADW, D.EC)}, D.RADW, EPI_GATES, bf.RAD, D.RADW);
    prad.gather = 1;
  }
  prad.bias = w[1];
  CK(launch_products(bf.en, {prad}, st));
  Op<B16>* flat = pick<B16>(bf.FLAT, bf.FLAT16);
  Op<B16>* act = pick<B16>(bf.ACT, bf.ACT16);
  eqv2_rotate_kernel<L, M, B16><<<D.B * D.A, receiver_threads(D.C), 0, st>>>(
      x, xi, idx, d, bf.RAD, bf.rs, bf.eidx, flat, D.A, D.C, D.KW);
  CK(cudaGetLastError());
  const float* fc1[8];
  const float* fc2[8];
  for (int m = 1; m <= D.M; ++m) {
    fc1[m - 1] = w[D.i_fc1(m)];
    fc2[m - 1] = w[D.i_fc2(m)];
  }
  std::vector<NNProb> c1;
  so2_conv<Op<B16>>(D, c1, flat, D.C2, w[2], D.W1N, fc1, bf.HID, bf.EXT);
  CK(launch_products(bf.en, c1, st));
  eqv2_grid_kernel<L, M, B16><<<edge_blocks(D), receiver_threads(D.CO), grid_smem(D), st>>>(
      bf.HID, bf.EXT + D.NX, tog, fromg, act, bf.n_rows, D.CO, D.EXTRA, D.P);
  CK(cudaGetLastError());
  std::vector<NNProb> c2;
  so2_conv<Op<B16>>(D, c2, act, D.CO, w[D.i_w2()], D.n0 * D.CO, fc2, bf.VAL, nullptr);
  return launch_products(bf.en, c2, st);
}

template <int L, int M, bool B16>
cudaError_t run_fwd(const Dims& D, const float* x, const float* xi, const int* idx,
                    const float* d, const float* xe, const float* maskf, const float* dropk,
                    const float* const* w, const float* tog, const float* fromg, float* agg,
                    float* scratch, int* iscratch, cudaStream_t st) {
  const Bufs bf = carve(D, scratch, iscratch, false, B16);
  CK(forward_stages<L, M, B16>(D, x, xi, idx, d, xe, maskf, w, tog, fromg, bf, st));
  const int il = D.i_lns();
  CK(allow_smem(eqv2_attn_out_kernel<L, M>, attn_smem(D, false)));
  eqv2_attn_out_kernel<L, M><<<D.B * D.A, receiver_threads(D.CO), attn_smem(D, false), st>>>(
      bf.VAL, bf.EXT, d, dropk, w[il], w[il + 1], w[il + 2], bf.rs, bf.eidx, agg, D.CO, D.NH,
      D.VA, D.EXTRA, D.KW);
  return cudaGetLastError();
}

// gw: the gradients' pointers, in the order of w
template <int L, int M, bool B16>
cudaError_t run_bwd(const Dims& D, const float* x, const float* xi, const int* idx,
                    const float* d, const float* xe, const float* maskf, const float* dropk,
                    const float* const* w, const float* tog, const float* fromg, const float* g,
                    float* gx, float* gxi, float* gxe, float* const* gw, float* scratch,
                    int* iscratch, cudaStream_t st) {
  using T = Op<B16>;
  const Bufs bf = carve(D, scratch, iscratch, true, B16);
  CK(forward_stages<L, M, B16>(D, x, xi, idx, d, xe, maskf, w, tog, fromg, bf, st));
  T* gval = pick<B16>(bf.GVAL, bf.GVAL16);
  T* gext = pick<B16>(bf.GEXT, bf.GEXT16);
  T* gact = pick<B16>(bf.GACT, bf.GACT16);  // the hidden rows' cotangent, as conv 1 reads it
  const int il = D.i_lns();
  CK(allow_smem(eqv2_attn_bwd_kernel<L, M, B16>, attn_smem(D, true)));
  eqv2_attn_bwd_kernel<L, M, B16><<<D.B * D.A, receiver_threads(D.CO), attn_smem(D, true), st>>>(
      bf.VAL, bf.EXT, d, dropk, w[il], w[il + 1], w[il + 2], g, bf.rs, bf.eidx, gval, gext,
      bf.LNG, D.K, D.CO, D.NH, D.VA, D.EXTRA, D.KW);
  CK(cudaGetLastError());

  const float* fc1[8];
  const float* fc2[8];
  float* gfc1[8];
  float* gfc2[8];
  for (int m = 1; m <= D.M; ++m) {
    fc1[m - 1] = w[D.i_fc1(m)];
    fc2[m - 1] = w[D.i_fc2(m)];
    gfc1[m - 1] = gw[D.i_fc1(m)];
    gfc2[m - 1] = gw[D.i_fc2(m)];
  }
  // conv 2: weight gradients, then the activation's cotangent
  std::vector<TNProb> t2;
  so2_conv_w<T>(D, t2, pick<B16>(bf.ACT, bf.ACT16), gval, nullptr, D.CO, D.n0 * D.CO,
                gw[D.i_w2()], gfc2);
  CK(launch_wgrads(bf.en, t2, st));
  std::vector<NNProb> p2;
  so2_conv_t<T>(D, p2, gval, nullptr, D.CO, w[D.i_w2()], D.n0 * D.CO, fc2, bf.GACT);
  CK(launch_products(bf.en, p2, st));
  // the grid activation (the hidden rows' cotangent from GACT into gact, GEXT's gate columns)
  eqv2_grid_bwd_kernel<L, M, B16><<<edge_blocks(D), receiver_threads(D.CO), grid_smem(D), st>>>(
      bf.HID, bf.EXT + D.NX, tog, fromg, bf.GACT, gact, gext + D.NX, bf.n_rows, D.CO, D.EXTRA,
      D.P);
  CK(cudaGetLastError());
  // conv 1: weight gradients, then the scaled stack's cotangent GFLAT
  std::vector<TNProb> t1;
  so2_conv_w<T>(D, t1, pick<B16>(bf.FLAT, bf.FLAT16), gact, gext, D.C2, D.W1N, gw[2], gfc1);
  CK(launch_wgrads(bf.en, t1, st));
  std::vector<NNProb> p1;
  so2_conv_t<T>(D, p1, gact, gext, D.C2, w[2], D.W1N, fc1, bf.GFLAT);
  CK(launch_products(bf.en, p1, st));
  // radial scale and rotations (RAD becomes the radial scale's cotangent), gxi
  eqv2_rot_bwd_kernel<L, M, B16><<<D.B * D.A, receiver_threads(D.C), 0, st>>>(
      x, xi, idx, d, bf.RAD, bf.GFLAT, bf.rs, bf.eidx, gxi, bf.GRAD16, D.A, D.C, D.KW);
  CK(cudaGetLastError());
  const T* grad = pick<B16>(bf.RAD, bf.GRAD16);
  NNProb pxe =
      prob({seg(av(grad), D.RADW, w[0], D.RADW, D.RADW, true)}, D.EC, EPI_STORE, gxe, D.EC);
  pxe.scatter = 1;
  CK(launch_products(bf.en, {pxe}, st));
  std::vector<TNProb> t3;
  if constexpr (B16)  // xe's live rows, in order
    t3.push_back(tprob({TSeg{av(bf.XE16), av(grad), D.EC, D.RADW, 1.f}}, A_ROWS, D.EC, D.RADW,
                       gw[0], D.RADW));
  else
    t3.push_back(tprob({TSeg{xe, grad, D.EC, D.RADW, 1.f}}, A_GATHER, D.EC, D.RADW, gw[0],
                       D.RADW));
  t3.push_back(tprob({TSeg{nullptr, bf.RAD, 0, D.RADW, 1.f}}, A_ONES, 1, D.RADW, gw[1], D.RADW));
  for (int q = 0; q < 3; ++q)
    t3.push_back(tprob({TSeg{nullptr, bf.LNG + q * D.NX, 0, 3 * D.NX, 1.f}}, A_ONES, 1, D.NX,
                       gw[il + q], D.NX));
  CK(launch_wgrads(bf.en, t3, st));
  // gx through the gather's transpose: the per-sender lists, then the sender-owned sums
  const int lt = (D.A + 31) / 32 * 32;
  eqv2_sender_list_kernel<<<D.B, lt, sizeof(int) * lt, st>>>(idx, bf.flags, bf.slist, bf.sbeg,
                                                              bf.scnt, D.A, D.K);
  CK(cudaGetLastError());
  eqv2_gx_kernel<L, M, B16><<<D.B * D.A, receiver_threads(D.C), 0, st>>>(
      bf.GFLAT, d, bf.slist, bf.sbeg, bf.scnt, bf.pos, gx, D.C, D.KW);
  return cudaGetLastError();
}

bool supported(int L, int M) { return L == 6 && M == 2; }

bool valid(const Dims& D) {
  return supported(D.L, D.M) && D.C % 8 == 0 && D.CO % 8 == 0 && D.EC % 8 == 0 &&
         D.NX % 8 == 0 && D.NH > 0 && D.CO % D.NH == 0 && D.VA <= 32 * VPL && D.A <= 1024 &&
         D.E < (1LL << 31);
}

int fwd_entry(const float* x, const float* xi, const int* idx, const float* d, const float* xe,
              const float* maskf, const float* dropk, const float* const* w, const float* tog,
              const float* fromg, float* agg, float* scratch, int* iscratch, int B, int A, int K,
              int C, int CO, int EC, int NH, int VA, int KW, int P, int l_max, int m_max,
              bool rnd, void* stream) {
  const Dims D = make_dims(B, A, K, C, CO, EC, NH, VA, KW, P, l_max, m_max);
  if (!valid(D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || K == 0) return 0;
  const auto run = rnd ? run_fwd<6, 2, true> : run_fwd<6, 2, false>;
  return (int)run(D, x, xi, idx, d, xe, maskf, dropk, w, tog, fromg, agg, scratch, iscratch,
                  static_cast<cudaStream_t>(stream));
}

int bwd_entry(const float* x, const float* xi, const int* idx, const float* d, const float* xe,
              const float* maskf, const float* dropk, const float* const* w, const float* tog,
              const float* fromg, const float* g, float* gx, float* gxi, float* gxe,
              float* const* gw, float* scratch, int* iscratch, int B, int A, int K, int C, int CO,
              int EC, int NH, int VA, int KW, int P, int l_max, int m_max, bool rnd,
              void* stream) {
  const Dims D = make_dims(B, A, K, C, CO, EC, NH, VA, KW, P, l_max, m_max);
  if (!valid(D)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || K == 0) return 0;
  const auto run = rnd ? run_bwd<6, 2, true> : run_bwd<6, 2, false>;
  return (int)run(D, x, xi, idx, d, xe, maskf, dropk, w, tog, fromg, g, gx, gxi, gxe, gw, scratch,
                  iscratch, static_cast<cudaStream_t>(stream));
}

// a probe's operand mode: 0 float32, 1 rounding (rbf16), 2 bf16 operands (b16); 1 when
// every segment of the n problems (`per` ints each, its segments' modes at `at` + `step` s;
// wgrad: column sums not counted) is in mode 2, 0 when none is, -1 when they mix
int probe_b16(int n, const int* ints, int per, int at, int step, int nseg_max, bool wgrad) {
  int twos = 0, all = 0;
  for (int q = 0; q < n; ++q) {
    const int* I = ints + q * per;
    if (wgrad && I[1] == A_ONES) continue;
    for (int s = 0; s < I[0] && s < nseg_max; ++s, ++all) twos += I[at + step * s] == 2;
  }
  return twos == 0 ? 0 : twos == all ? 1 : -1;
}

// so2_wgrads_probe's arrays hold 1 or 2 segments, a known A mode and operand modes 0-2 per
// problem, and not both the bf16 operand mode and another
bool probe_valid(int np, const int* ints) {
  for (int q = 0; q < np; ++q) {
    const int* I = ints + q * 13;
    if (I[0] < 1 || I[0] > 2 || I[1] < A_ROWS || I[1] > A_ONES) return false;
    for (int s = 0; s < I[0]; ++s)
      if (I[8 + 4 * s] < 0 || I[8 + 4 * s] > 2) return false;
  }
  return probe_b16(np, ints, 13, 8, 4, 2, true) >= 0;
}

// the weight-gradient problems of so2_wgrads_probe's arrays (ptrs null: shapes only)
std::vector<TNProb> probe_tprobs(int np, const int* ints, const void* const* ptrs) {
  std::vector<TNProb> probs;
  for (int q = 0; q < np; ++q) {
    const int* I = ints + q * 13;
    const void* const* Q = ptrs ? ptrs + q * 5 : nullptr;
    TNProb p{};
    p.nseg = I[0];  // 1 or 2: the callers check
    p.amode = I[1];
    p.m = I[2];
    p.n = I[3];
    p.ldo = I[4];
    p.out = Q ? (float*)Q[0] : nullptr;
    for (int s = 0; s < p.nseg; ++s) {
      const int* J = I + 5 + 4 * s;
      p.seg[s] = TSeg{Q ? (const float*)Q[1 + 2 * s] : nullptr,
                      Q ? (const float*)Q[2 + 2 * s] : nullptr, J[0], J[1], (float)J[2], 0,
                      J[3] == 1};
    }
    probs.push_back(p);
  }
  return probs;
}

}  // namespace

extern "C" {

// 1 when the kernels are built for (l_max, m_max), else 0
int eqv2_supported(int l_max, int m_max) { return supported(l_max, m_max) ? 1 : 0; }

// float and int scratch the wrappers allocate (bwd 0: kernel O, 1: kernel P; bf16: the
// bf16 mode's)
long long eqv2_scratch_floats(int bwd, int bf16, int B, int A, int K, int C, int CO, int EC,
                              int NH, int VA, int l_max, int m_max) {
  return scratch_floats(make_dims(B, A, K, C, CO, EC, NH, VA, 0, 0, l_max, m_max), bwd != 0,
                        bf16 != 0);
}

long long eqv2_scratch_ints(int B, int A, int K) { return scratch_ints(B, A, K); }

// Each returns a cudaError_t (0 = success), launches on `stream`, does not sync;
// cudaErrorInvalidValue for an (l_max, m_max) the kernels are not built for, for C, CO, EC
// or NH VA not a multiple of 8, CO not a multiple of NH, VA > 128 or A > 1024. w: the
// 7 + 2 m_max weight pointers (w_rad, b_rad, w1, fc1_m1..M, w2, fc2_m1..M, ln_scale,
// ln_bias, alpha_dot); tog [P, S_t] and fromg [S_t, P] the truncated grid's tables.
int eqv2_fwd(const float* x, const float* xi, const int* idx, const float* d, const float* xe,
             const float* maskf, const float* dropk, const float* const* w, const float* tog,
             const float* fromg, float* agg, float* scratch, int* iscratch, int B, int A, int K,
             int C, int CO, int EC, int NH, int VA, int KW, int P, int l_max, int m_max,
             void* stream) {
  return fwd_entry(x, xi, idx, d, xe, maskf, dropk, w, tog, fromg, agg, scratch, iscratch, B, A, K,
                   C, CO, EC, NH, VA, KW, P, l_max, m_max, false, stream);
}

// eqv2_fwd in the bf16 mode (the rounding points above)
int eqv2_fwd_bf16(const float* x, const float* xi, const int* idx, const float* d,
                  const float* xe, const float* maskf, const float* dropk, const float* const* w,
                  const float* tog, const float* fromg, float* agg, float* scratch,
                  int* iscratch, int B, int A, int K, int C, int CO, int EC, int NH, int VA,
                  int KW, int P, int l_max, int m_max, void* stream) {
  return fwd_entry(x, xi, idx, d, xe, maskf, dropk, w, tog, fromg, agg, scratch, iscratch, B, A, K,
                   C, CO, EC, NH, VA, KW, P, l_max, m_max, true, stream);
}

// gw: the gradients' pointers, in the order of w. gxe must hold zeros: only the live
// edges' rows are written.
int eqv2_bwd(const float* x, const float* xi, const int* idx, const float* d, const float* xe,
             const float* maskf, const float* dropk, const float* const* w, const float* tog,
             const float* fromg, const float* g, float* gx, float* gxi, float* gxe,
             float* const* gw, float* scratch, int* iscratch, int B, int A, int K, int C, int CO,
             int EC, int NH, int VA, int KW, int P, int l_max, int m_max, void* stream) {
  return bwd_entry(x, xi, idx, d, xe, maskf, dropk, w, tog, fromg, g, gx, gxi, gxe, gw, scratch,
                   iscratch, B, A, K, C, CO, EC, NH, VA, KW, P, l_max, m_max, false, stream);
}

// eqv2_bwd in the bf16 mode (`_attn_pipeline_bwd` with mxu_bf16: the rounding points above)
int eqv2_bwd_bf16(const float* x, const float* xi, const int* idx, const float* d,
                  const float* xe, const float* maskf, const float* dropk, const float* const* w,
                  const float* tog, const float* fromg, const float* g, float* gx, float* gxi,
                  float* gxe, float* const* gw, float* scratch, int* iscratch, int B, int A,
                  int K, int C, int CO, int EC, int NH, int VA, int KW, int P, int l_max,
                  int m_max, void* stream) {
  return bwd_entry(x, xi, idx, d, xe, maskf, dropk, w, tog, fromg, g, gx, gxi, gxe, gw, scratch,
                   iscratch, B, A, K, C, CO, EC, NH, VA, KW, P, l_max, m_max, true, stream);
}

// The product engine on one caller-given problem list (its card test and chip_smoke's
// so2_products line). Rows 0..*n_rows-1 of max_rows, row list eidx (gather / scatter).
// Per problem, 8 + 6 MAXSEG ints: nseg, gather, scatter, epi, n, ldc, ldc2, ldg, then per
// segment (MAXSEG slots) lda, ldb, k, btrans, sign (+1 / -1), mode (0 float32; 1 rbf16: both
// operands rounded to bf16; 2 the bf16 operand mode: A bf16 values, B rounded in the prep;
// 2 in every segment or in none); 4 + 2 MAXSEG pointers: c, c2, bias, gate, then per segment
// a, b. prep: 2 * sum of n * k floats over the segments. persistent: one block per SM over
// all the tiles (launch_products; not in mode 2).
int so2_products_probe(int np, const int* ints, const void* const* ptrs, long long max_rows,
                       const int* n_rows, const int* eidx, float* prep, long long prep_floats,
                       int persistent, void* stream) {
  for (int q = 0; q < np; ++q) {
    const int* I = ints + q * (8 + 6 * MAXSEG);
    for (int s = 0; s < I[0] && s < MAXSEG; ++s)
      if (I[8 + 6 * s + 5] < 0 || I[8 + 6 * s + 5] > 2) return (int)cudaErrorInvalidValue;
  }
  const int b16 = probe_b16(np, ints, 8 + 6 * MAXSEG, 13, 6, MAXSEG, false);
  if (b16 < 0) return (int)cudaErrorInvalidValue;
  std::vector<NNProb> probs;
  for (int q = 0; q < np; ++q) {
    const int* I = ints + q * (8 + 6 * MAXSEG);
    const void* const* Q = ptrs + q * (4 + 2 * MAXSEG);
    NNProb p{};
    p.nseg = I[0];
    if (p.nseg < 1 || p.nseg > MAXSEG) return (int)cudaErrorInvalidValue;
    p.gather = I[1];
    p.scatter = I[2];
    p.epi = I[3];
    p.n = I[4];
    p.ldc = I[5];
    p.ldc2 = I[6];
    p.ldg = I[7];
    p.c = (float*)Q[0];
    p.c2 = (float*)Q[1];
    p.bias = (const float*)Q[2];
    p.gate = (const float*)Q[3];
    for (int s = 0; s < p.nseg; ++s) {
      const int* J = I + 8 + 6 * s;
      p.seg[s] = seg((const float*)Q[4 + 2 * s], J[0], (const float*)Q[5 + 2 * s], J[1], J[2],
                     J[3] != 0, (float)J[4]);
      p.seg[s].rbf16 = J[5] == 1;
    }
    probs.push_back(p);
  }
  const Engine en{max_rows, n_rows, eidx, prep, prep_floats, nullptr, 0, 0, b16};
  return (int)launch_products(en, probs, static_cast<cudaStream_t>(stream), persistent != 0);
}

// Weight gradients on one caller-given problem list. Per problem, 13 ints:
// nseg, amode (0 rows, 1 gather, 2 ones), m, n, ldo, then per segment (2 slots) lda, ldb,
// sign, mode (as so2_products_probe's; mode 2: A and B bf16 values, amode rows or ones);
// 5 pointers: out, then per segment a, b. part: so2_wgrads_part_floats.
long long so2_wgrads_part_floats(int np, const int* ints, long long max_rows) {
  if (!probe_valid(np, ints)) return -1;
  return wgrad_part_floats(max_rows, probe_tprobs(np, ints, nullptr));
}

int so2_wgrads_probe(int np, const int* ints, const void* const* ptrs, long long max_rows,
                     const int* n_rows, const int* eidx, float* part, long long part_floats,
                     void* stream) {
  if (!probe_valid(np, ints)) return (int)cudaErrorInvalidValue;
  const int b16 = probe_b16(np, ints, 13, 8, 4, 2, true);
  const Engine en{max_rows, n_rows, eidx, nullptr, 0, part, part_floats, 0, b16};
  return (int)launch_wgrads(en, probe_tprobs(np, ints, ptrs), static_cast<cudaStream_t>(stream));
}

// The live-row list (live_rows) of 0/1 flags [npairs] in segments of seg slots: eidx and pos
// [npairs], rs [npairs / seg + 1], n_rows [1].
int so2_live_rows_probe(const int* flags, int* eidx, int* pos, int* rs, int* n_rows,
                        long long npairs, int seg, void* stream) {
  if (seg <= 0 || npairs < 0 || npairs % seg || npairs >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return (int)live_rows(flags, eidx, pos, rs, n_rows, npairs, seg,
                        static_cast<cudaStream_t>(stream));
}

// The bf16 mode's radial-product rows alone (eqv2_rows16_kernel): out[e] = xe[eidx[e]]
// rounded to bf16, nearest-even, for e < *n_rows of max_rows; xe [., EC] float32 and out
// [max_rows, EC], EC a multiple of 8.
int eqv2_rows16_probe(const float* xe, const int* eidx, const int* n_rows, uint16_t* out,
                      long long max_rows, int EC, void* stream) {
  if (EC <= 0 || EC % 8 || max_rows < 0) return (int)cudaErrorInvalidValue;
  if (max_rows == 0) return 0;
  eqv2_rows16_kernel<<<(unsigned)std::min<long long>(max_rows, 2048), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(xe, eidx, n_rows, out, EC);
  return (int)cudaGetLastError();
}

}  // extern "C"
