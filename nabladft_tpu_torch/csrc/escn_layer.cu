// Fused eSCN message layer for Hopper (sm_90a): kernels M and N.
//
// Kernel M replaces nabladft_tpu/ops/pallas/escn_layer.py `_fwd_kernel` (pallas_call in
// `_run_fwd`); kernel N replaces `_bwd_kernel` (`_run_bwd`), the backward of the custom_vjp
// `escn_message` for x, xe and every weight. Per molecule b and receiver i, over the
// neighbours j whose masked compact Wigner row d[b,i,j,:] is not zero (a live pair):
//   1. src = D x_j and tgt = D x_i, the m-major truncated stacks [S_t, C];
//   2. per stream s (source, target): gates silu(xe wg_s + bg_s) [5H], then the SO(2)
//      block: m=0 (f0 W1_0 * g0) W2_0; m=1..M the packed fc1 over the +m and -m rows, the
//      r / i halves gated and multiplied by w2r / w2i, recombined as (rp - im, rm + ip);
//   3. the two streams summed, silu on the truncated S2 grid (to_g [P, S_t], from_g);
//   4. rotated back with D^T and summed over j: out[b,i] [S, C].
//
// Layouts: x [B,A,S,C]; d [B,A,A,K] (compact, masked); xe [B,A,A,EC]; wg [2,EC,5H];
// bg [2,1,5H]; w1_0 [2,(L+1)C,H]; w2_0 [2,H,(L+1)C]; per m fc1 [2,n_l C,2H], w2r, w2i
// [2,H,n_l C]; out and its cotangent g [B,A,S,C]; float32, contiguous.
//
// What bounds them on the card: the SO(2) products, ~13 of the ~14.6 MFLOP per live pair
// at L=6, M=2, C=128, H=256, EC=128 (the JAX package's FLOP model). A train step of 16
// molecules at A=48 is some 3 TFLOP in M and N. In fp32-accurate arithmetic that is the
// tensor cores' 3xTF32 rate (495 / 3 TFLOP/s on an H100 SXM), not the fp32 FMA rate (67).
// What the design does about it:
//   * The Pallas kernel runs one program per receiver with its [A, .] rows in VMEM and its
//     weights (16.5 MB) resident. A Hopper block has 227 KB, and a receiver has at most
//     40 live rows, so a per-receiver product would read each weight tile for <= 40 rows.
//     Here the products run over ALL live pairs of the batch at once on so2_common.cuh's
//     engine: 3xTF32 wgmma over [E_live, K] x [K, N] in 128 x 128 tiles, fed by TMA and
//     cp.async through an mbarrier ring, so each weight tile feeds 128 pair rows. The
//     per-pair rows (rotated inputs, gates, hidden) pass through device memory: ~15k floats
//     a pair forward.
//   * One product kernel serves every matrix of the layer: a launch takes a list of
//     problems, each a sum of up to four segments A_k B_k (sign, B read as [K,N] or
//     transposed), with the gate multiply, bias + silu, or a row scatter in its epilogue.
//     So the m>0 recombination (rp - im) and the sum of the two streams are one product
//     each, and nothing is added in a separate pass.
//   * Dead pairs are skipped: a pair whose d row is zero maps to exactly zero in every
//     stage (no bias in the SO(2) products, silu(0) = 0). A scan lists the live pairs in
//     (b, i, j) order; the products run over that list, and blocks past its length exit.
//   * Rotation, grid activation and the sum over j are per receiver (one block each, one
//     thread a channel, the stacks in registers, loops unrolled at compile time for L, M).
//   * N recomputes the forward products, then the transposed products per pair, and the
//     weight gradients as products over all live pairs: each a split of the pair rows
//     sized from the tile count into partial tiles, summed in a fixed order. gx is a sum
//     over receivers: a sender-owned kernel walks the pairs (i, a) in order of i, then the
//     receiver's own pairs (a, j). No float atomics: N gives the same bits on every run.
// The products are fp32-accurate (3xTF32; the tolerance is 2e-5 of the output's scale), the
// rest plain fp32 FMA. The engine, the scan and the m-major row tables are in
// so2_common.cuh, shared with kernels O and P (csrc/eqv2_attn.cu).
// The bf16 mode (escn_fwd_bf16 / escn_bwd_bf16; the TPU kernels' mxu_bf16, the model's
// compute_dtype bfloat16): every product that `_message_pipeline` and the hand-written
// `_pipeline_bwd` pass through `_mdot` rounds both operands to bf16 (the gate products, the
// SO(2) products, their transposes and every weight gradient) and runs one TF32 pass of the
// rounded values, summed in fp32 (the engine's `rbf16`); inputs, outputs, gates, the grid
// activation, the rotations, the bias gradients and every sum stay fp32.

#include <cuda_runtime.h>

#include <algorithm>
#include <vector>

#include "so2_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// the live-pair list: flags, then live_rows lists them in (b, i, j) order
// ---------------------------------------------------------------------------

__global__ void escn_flags_kernel(const float* __restrict__ d, int* __restrict__ flags,
                                  long long npairs, int K) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= npairs) return;  // the whole warp shares w
  bool nz = false;
  for (int k = lane; k < K; k += 32) nz |= __ldg(d + w * K + k) != 0.f;
  const bool live = __any_sync(0xffffffffu, nz);
  if (lane == 0) flags[w] = live ? 1 : 0;
}

// src[e] = D x_j and tgt[e] = D x_i of every live pair (b, i, j): [E, S_t * C], m-major
template <int L, int M>
__global__ void __launch_bounds__(RT) escn_rotate_kernel(
    const float* __restrict__ x, const float* __restrict__ d, const int* __restrict__ rs,
    const int* __restrict__ eidx, float* __restrict__ fs, float* __restrict__ ft, int A, int C,
    int K) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  const int bi = blockIdx.x, b = bi / A;
  const int e_lo = rs[bi], e_hi = rs[bi + 1];
  if (e_lo == e_hi) return;
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    const int cc = act ? c : 0;
    float xr[S];
#pragma unroll
    for (int s = 0; s < S; ++s) xr[s] = x[((long long)bi * S + s) * C + cc];
    for (int e = e_lo; e < e_hi; ++e) {
      const int p = eidx[e], j = p % A;
      const float* xj = x + ((long long)b * A + j) * S * C + cc;
      const float* dp = d + (long long)p * K;
      float xs[S];
#pragma unroll
      for (int s = 0; s < S; ++s) xs[s] = xj[(long long)s * C];
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
          fs[((long long)e * ST + r) * C + c] = as;
          ft[((long long)e * ST + r) * C + c] = at;
        }
      }
    }
  }
}

// kernel M's last stage: per receiver, each live pair's message through silu on the
// truncated grid, rotated back with D^T, summed over j in order
template <int L, int M>
__global__ void __launch_bounds__(RT) escn_grid_out_kernel(
    const float* __restrict__ msg, const float* __restrict__ d, const int* __restrict__ rs,
    const int* __restrict__ eidx, const float* __restrict__ tog, const float* __restrict__ fromg,
    float* __restrict__ out, int C, int K, int P) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  extern __shared__ float tab[];
  stage_grid(tog, fromg, P, ST, tab);
  const int bi = blockIdx.x;
  const int e_lo = rs[bi], e_hi = rs[bi + 1];
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    const int cc = act ? c : 0;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    for (int e = e_lo; e < e_hi; ++e) {
      const float* dp = d + (long long)eidx[e] * K;
      float m[ST], m2[ST];
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        m[r] = msg[((long long)e * ST + r) * C + cc];
        m2[r] = 0.f;
      }
      grid_silu<ST>(tab, P, m, m2);
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        const int l = row_l(L, M, r), base = row_base(L, M, r);
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          acc[l * l + col] = fmaf(__ldg(dp + base + col), m2[r], acc[l * l + col]);
        }
      }
    }
    if (act)
#pragma unroll
      for (int s = 0; s < S; ++s) out[((long long)bi * S + s) * C + c] = acc[s];
  }
}

// kernel N: the cotangent of each live pair's summed SO(2) output, in place of the
// recomputed message: rotate-back transpose of g, then the grid activation's backward
template <int L, int M>
__global__ void __launch_bounds__(RT) escn_grid_bwd_kernel(
    float* __restrict__ msg, const float* __restrict__ d, const int* __restrict__ rs,
    const int* __restrict__ eidx, const float* __restrict__ tog, const float* __restrict__ fromg,
    const float* __restrict__ g, int C, int K, int P) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  extern __shared__ float tab[];
  stage_grid(tog, fromg, P, ST, tab);
  const int bi = blockIdx.x;
  const int e_lo = rs[bi], e_hi = rs[bi + 1];
  if (e_lo == e_hi) return;
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    const int cc = act ? c : 0;
    float gi[S];
#pragma unroll
    for (int s = 0; s < S; ++s) gi[s] = g[((long long)bi * S + s) * C + cc];
    for (int e = e_lo; e < e_hi; ++e) {
      const float* dp = d + (long long)eidx[e] * K;
      float m[ST], gm2[ST], gm[ST];
#pragma unroll
      for (int r = 0; r < ST; ++r) {
        const int l = row_l(L, M, r), base = row_base(L, M, r);
        float t = 0.f;
#pragma unroll
        for (int col = 0; col < 2 * L + 1; ++col) {
          if (col >= 2 * l + 1) break;
          t = fmaf(__ldg(dp + base + col), gi[l * l + col], t);
        }
        gm2[r] = t;
        m[r] = msg[((long long)e * ST + r) * C + cc];
        gm[r] = 0.f;
      }
      grid_silu_bwd<ST>(tab, P, m, gm2, gm);
      if (act)
#pragma unroll
        for (int r = 0; r < ST; ++r) msg[((long long)e * ST + r) * C + c] = gm[r];
    }
  }
}

// kernel N's gx: per (molecule b, atom a), the rotation transpose of the source-stream
// cotangents of the pairs (i, a) over i in order, then of the target-stream cotangents
// of its own pairs (a, j) over j in order
template <int L, int M>
__global__ void __launch_bounds__(RT) escn_gx_kernel(
    const float* __restrict__ gfs, const float* __restrict__ gft, const float* __restrict__ d,
    const int* __restrict__ pos, float* __restrict__ gx, int A, int C, int K) {
  constexpr int S = (L + 1) * (L + 1), ST = s_trunc(L, M);
  const int ba = blockIdx.x, b = ba / A, a = ba - b * A;
  for (int c0 = 0; c0 < C; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool act = c < C;
    const int cc = act ? c : 0;
    float acc[S];
#pragma unroll
    for (int s = 0; s < S; ++s) acc[s] = 0.f;
    for (int side = 0; side < 2; ++side) {
      const float* gf = side == 0 ? gfs : gft;
      for (int o = 0; o < A; ++o) {
        const long long p = side == 0 ? ((long long)b * A + o) * A + a : (long long)ba * A + o;
        const int e = pos[p];
        if (e < 0) continue;
        const float* dp = d + p * K;
#pragma unroll
        for (int r = 0; r < ST; ++r) {
          const int l = row_l(L, M, r), base = row_base(L, M, r);
          const float v = gf[((long long)e * ST + r) * C + cc];
#pragma unroll
          for (int col = 0; col < 2 * L + 1; ++col) {
            if (col >= 2 * l + 1) break;
            acc[l * l + col] = fmaf(__ldg(dp + base + col), v, acc[l * l + col]);
          }
        }
      }
    }
    if (act)
#pragma unroll
      for (int s = 0; s < S; ++s) gx[((long long)ba * S + s) * C + c] = acc[s];
  }
}

// kernel N: the gate cotangents, in place of the gate pre-activations z:
// gg * silu'(z), gg = gh0 * f1 (m=0), gh_r(+m) hr(+m) + gh_r(-m) hr(-m) (and i alike)
__global__ void __launch_bounds__(256) escn_gate_grad_kernel(
    const float* __restrict__ gh0, const float* __restrict__ gh1, const float* __restrict__ hd0,
    const float* __restrict__ hd1, float* __restrict__ z0, float* __restrict__ z1,
    const int* __restrict__ n_rows, int H, int M) {
  const float* gh = blockIdx.y ? gh1 : gh0;
  const float* hd = blockIdx.y ? hd1 : hd0;
  float* z = blockIdx.y ? z1 : z0;
  const int G = (2 * M + 1) * H, Hw = H * (1 + 4 * M);
  const long long n = (long long)(*n_rows) * G;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    const long long e = idx / G;
    const int q = (int)(idx - e * G);
    const float* ghe = gh + e * Hw;
    const float* hde = hd + e * Hw;
    float gg;
    if (q < H) {
      gg = ghe[q] * hde[q];
    } else {
      const int m = (q / H + 1) / 2, w = q - (2 * m - 1) * H;  // w in [0, 2H): r then i
      const int mp = H + (m - 1) * 4 * H, mm = mp + 2 * H;
      gg = ghe[mp + w] * hde[mp + w] + ghe[mm + w] * hde[mm + w];
    }
    z[idx] = gg * dsilu(z[idx]);
  }
}

// ---------------------------------------------------------------------------
// host side: shapes, scratch, and the problem lists of each stage
// ---------------------------------------------------------------------------

struct Dims {
  int B, A, C, H, EC, K, P, L, M;
  long long E;        // pair slots B*A*A (the live pairs are a prefix of them)
  int S, ST, STC, G, Hw, n0;
  // m-major span starts of +m / -m (rows) and the hidden layout: h0 [H], then per m the
  // +m rows' [hr | hi] [2H] and the -m rows' [2H]
  int span_p(int m) const {
    int off = L + 1;
    for (int q = 1; q < m; ++q) off += 2 * (L + 1 - q);
    return off;
  }
  int span_m(int m) const { return span_p(m) + (L + 1 - m); }
  int nl(int m) const { return L + 1 - m; }
  int hp(int m) const { return H + (m - 1) * 4 * H; }
  int hm(int m) const { return hp(m) + 2 * H; }
};

Dims make_dims(int B, int A, int C, int H, int EC, int K, int P, int L, int M) {
  Dims D{B, A, C, H, EC, K, P, L, M};
  D.E = (long long)B * A * A;
  D.S = (L + 1) * (L + 1);
  D.ST = s_trunc(L, M);
  D.STC = D.ST * C;
  D.G = (2 * M + 1) * H;
  D.Hw = H * (1 + 4 * M);
  D.n0 = (L + 1) * C;
  return D;
}

// the weights of stream s (0 source, 1 target): w[0] wg, w[1] bg, w[2] w1_0, w[3] w2_0,
// then per m: fc1, w2r, w2i (each [2, ...])
struct W {
  const float *wg, *bg, *w10, *w20, *fc1[8], *w2r[8], *w2i[8];
};

W stream_weights(const Dims& D, const float* const* w, int s) {
  W o{};
  const long long C = D.C, H = D.H;
  o.wg = w[0] + s * (long long)D.EC * D.G;
  o.bg = w[1] + s * (long long)D.G;
  o.w10 = w[2] + s * (long long)D.n0 * H;
  o.w20 = w[3] + s * H * D.n0;
  for (int m = 1; m <= D.M; ++m) {
    const long long nlc = D.nl(m) * C;
    o.fc1[m - 1] = w[4 + 3 * (m - 1)] + s * nlc * 2 * H;
    o.w2r[m - 1] = w[5 + 3 * (m - 1)] + s * H * nlc;
    o.w2i[m - 1] = w[6 + 3 * (m - 1)] + s * H * nlc;
  }
  return o;
}

struct Bufs {
  float *F[2], *Z[2], *Gt[2], *Hd[2], *Hg[2], *GM, *GH[2], *GHID[2];
  int *flags, *eidx, *pos, *rs, *n_rows;
  Engine en;
};

// the weights' floats (both streams): the engine's TF32 halves take twice this
long long weight_floats(const Dims& D) {
  long long n = (long long)D.EC * D.G + D.G + 2LL * D.n0 * D.H;
  for (int m = 1; m <= D.M; ++m) n += 4LL * D.nl(m) * D.C * D.H;
  return 2 * n;
}

// partial floats of the weight-gradient launches (the column sums: one stream's bg)
long long part_floats(const Dims& D) { return part_bound(D.G); }

// forward: F[2] [E,STC], Gt[2] [E,G], Hg[2] [E,Hw] (the message overwrites F[0]) and the
// weights' halves; backward adds Z[2], Hd[2], GH[2], GHID[2], GM and the partial tiles
long long scratch_floats(const Dims& D, bool bwd) {
  const long long prep = 2 * weight_floats(D);
  if (!bwd) return D.E * (2LL * D.STC + 2LL * D.G + 2LL * D.Hw) + prep;
  return D.E * (3LL * D.STC + 4LL * D.G + 8LL * D.Hw) + prep + part_floats(D);
}

long long scratch_ints(int B, int A) { return 3LL * B * A * A + (long long)B * A + 2; }

Bufs carve(const Dims& D, float* f, int* iw, bool bwd, bool rnd) {
  Bufs b{};
  auto take = [&](long long per) {
    float* p = f;
    f += D.E * per;
    return p;
  };
  b.F[0] = take(D.STC);
  b.F[1] = take(D.STC);
  b.Gt[0] = take(D.G);
  b.Gt[1] = take(D.G);
  b.Hg[0] = take(D.Hw);
  b.Hg[1] = take(D.Hw);
  if (bwd) {
    b.Z[0] = take(D.G);
    b.Z[1] = take(D.G);
    b.Hd[0] = take(D.Hw);
    b.Hd[1] = take(D.Hw);
    b.GH[0] = take(D.Hw);
    b.GH[1] = take(D.Hw);
    b.GHID[0] = take(D.Hw);
    b.GHID[1] = take(D.Hw);
    b.GM = take(D.STC);
  }
  b.flags = iw;
  b.eidx = iw + D.E;
  b.pos = iw + 2 * D.E;
  b.rs = iw + 3 * D.E;
  b.n_rows = b.rs + (long long)D.B * D.A + 1;
  const long long prep = 2 * weight_floats(D);
  b.en = Engine{D.E, b.n_rows, b.eidx, f, prep, f + prep, bwd ? part_floats(D) : 0, rnd};
  return b;
}

// the live-pair list, the rotated stacks, gates, hidden and the summed SO(2) message
// (into msg [E, STC]); `bwd` also keeps the pre-activations Z and the ungated hidden Hd
template <int L, int M>
cudaError_t forward_stages(const Dims& D, const float* x, const float* d, const float* xe,
                           const float* const* w, const Bufs& bf, float* msg, bool bwd,
                           cudaStream_t st) {
  const long long npairs = D.E;
  escn_flags_kernel<<<(unsigned)((npairs * 32 + 255) / 256), 256, 0, st>>>(d, bf.flags, npairs,
                                                                           D.K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if ((err = live_rows(bf.flags, bf.eidx, bf.pos, bf.rs, bf.n_rows, npairs, D.A, st)) !=
      cudaSuccess)
    return err;
  escn_rotate_kernel<L, M><<<D.B * D.A, receiver_threads(D.C), 0, st>>>(
      x, d, bf.rs, bf.eidx, bf.F[0], bf.F[1], D.A, D.C, D.K);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const W ws[2] = {stream_weights(D, w, 0), stream_weights(D, w, 1)};
  const int C = D.C, H = D.H, G = D.G, Hw = D.Hw, STC = D.STC;
  std::vector<NNProb> gates;
  for (int s = 0; s < 2; ++s) {
    NNProb p = prob({seg(xe, D.EC, ws[s].wg, G, D.EC)}, G, EPI_GATES, bwd ? bf.Z[s] : nullptr, G,
                    bf.Gt[s], G);
    p.gather = 1;
    p.bias = ws[s].bg;
    gates.push_back(p);
  }
  if ((err = launch_products(bf.en, gates, st)) != cudaSuccess) return err;

  std::vector<NNProb> hidden;
  for (int s = 0; s < 2; ++s) {
    float* hd = bwd ? bf.Hd[s] : nullptr;
    const float* f = bf.F[s];
    hidden.push_back(gated(prob({seg(f, STC, ws[s].w10, H, D.n0)}, H, EPI_GATED, hd, Hw,
                                bf.Hg[s], Hw), bf.Gt[s], G));
    for (int m = 1; m <= D.M; ++m) {
      const int nlc = D.nl(m) * C;
      const float* gate = bf.Gt[s] + (2 * m - 1) * H;
      for (int side = 0; side < 2; ++side) {
        const int span = side ? D.span_m(m) : D.span_p(m), ho = side ? D.hm(m) : D.hp(m);
        hidden.push_back(gated(prob({seg(f + span * C, STC, ws[s].fc1[m - 1], 2 * H, nlc)},
                                    2 * H, EPI_GATED, hd ? hd + ho : nullptr, Hw, bf.Hg[s] + ho,
                                    Hw), gate, G));
      }
    }
  }
  if ((err = launch_products(bf.en, hidden, st)) != cudaSuccess) return err;

  // the message of both streams: m=0 rows, then per m: rp - im and rm + ip
  std::vector<NNProb> out;
  out.push_back(prob({seg(bf.Hg[0], Hw, ws[0].w20, D.n0, H), seg(bf.Hg[1], Hw, ws[1].w20, D.n0, H)},
                     D.n0, EPI_STORE, msg, STC));
  for (int m = 1; m <= D.M; ++m) {
    const int nlc = D.nl(m) * C;
    const int hp = D.hp(m), hm = D.hm(m);
    out.push_back(prob({seg(bf.Hg[0] + hp, Hw, ws[0].w2r[m - 1], nlc, H),
                        seg(bf.Hg[0] + hm + H, Hw, ws[0].w2i[m - 1], nlc, H, false, -1.f),
                        seg(bf.Hg[1] + hp, Hw, ws[1].w2r[m - 1], nlc, H),
                        seg(bf.Hg[1] + hm + H, Hw, ws[1].w2i[m - 1], nlc, H, false, -1.f)},
                       nlc, EPI_STORE, msg + D.span_p(m) * C, STC));
    out.push_back(prob({seg(bf.Hg[0] + hm, Hw, ws[0].w2r[m - 1], nlc, H),
                        seg(bf.Hg[0] + hp + H, Hw, ws[0].w2i[m - 1], nlc, H),
                        seg(bf.Hg[1] + hm, Hw, ws[1].w2r[m - 1], nlc, H),
                        seg(bf.Hg[1] + hp + H, Hw, ws[1].w2i[m - 1], nlc, H)},
                       nlc, EPI_STORE, msg + D.span_m(m) * C, STC));
  }
  return launch_products(bf.en, out, st);
}

size_t grid_smem(const Dims& D) { return sizeof(float) * 2 * (size_t)D.P * D.ST; }

template <int L, int M>
cudaError_t run_fwd(const Dims& D, const float* x, const float* d, const float* xe,
                    const float* const* w, const float* tog, const float* fromg, float* out,
                    float* scratch, int* iscratch, bool rnd, cudaStream_t st) {
  const Bufs bf = carve(D, scratch, iscratch, false, rnd);
  float* msg = bf.F[0];  // the rotated source stack is spent once the hidden are formed
  cudaError_t err = forward_stages<L, M>(D, x, d, xe, w, bf, msg, false, st);
  if (err != cudaSuccess) return err;
  escn_grid_out_kernel<L, M><<<D.B * D.A, receiver_threads(D.C), grid_smem(D), st>>>(
      msg, d, bf.rs, bf.eidx, tog, fromg, out, D.C, D.K, D.P);
  return cudaGetLastError();
}

template <int L, int M>
cudaError_t run_bwd(const Dims& D, const float* x, const float* d, const float* xe,
                    const float* const* w, const float* tog, const float* fromg, const float* g,
                    float* gx, float* gxe, float* const* gw, float* scratch, int* iscratch,
                    bool rnd, cudaStream_t st) {
  const Bufs bf = carve(D, scratch, iscratch, true, rnd);
  cudaError_t err = forward_stages<L, M>(D, x, d, xe, w, bf, bf.GM, true, st);
  if (err != cudaSuccess) return err;
  escn_grid_bwd_kernel<L, M><<<D.B * D.A, receiver_threads(D.C), grid_smem(D), st>>>(
      bf.GM, d, bf.rs, bf.eidx, tog, fromg, g, D.C, D.K, D.P);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const W ws[2] = {stream_weights(D, w, 0), stream_weights(D, w, 1)};
  const int C = D.C, H = D.H, G = D.G, Hw = D.Hw, STC = D.STC, n0 = D.n0;
  // hidden cotangents per pair, ungated (GH) and gated (GHID), in the hidden layout
  std::vector<NNProb> gh;
  for (int s = 0; s < 2; ++s) {
    gh.push_back(gated(prob({seg(bf.GM, STC, ws[s].w20, n0, n0, true)}, H, EPI_GATED, bf.GH[s],
                            Hw, bf.GHID[s], Hw), bf.Gt[s], G));
    for (int m = 1; m <= D.M; ++m) {
      const int nlc = D.nl(m) * C, sp = D.span_p(m) * C, sm = D.span_m(m) * C;
      const int hp = D.hp(m), hm = D.hm(m);
      const float* gr = bf.Gt[s] + (2 * m - 1) * H;
      const float* gi = bf.Gt[s] + 2 * m * H;
      const float *w2r = ws[s].w2r[m - 1], *w2i = ws[s].w2i[m - 1];
      gh.push_back(gated(prob({seg(bf.GM + sp, STC, w2r, nlc, nlc, true)}, H, EPI_GATED,
                              bf.GH[s] + hp, Hw, bf.GHID[s] + hp, Hw), gr, G));
      gh.push_back(gated(prob({seg(bf.GM + sm, STC, w2i, nlc, nlc, true)}, H, EPI_GATED,
                              bf.GH[s] + hp + H, Hw, bf.GHID[s] + hp + H, Hw), gi, G));
      gh.push_back(gated(prob({seg(bf.GM + sm, STC, w2r, nlc, nlc, true)}, H, EPI_GATED,
                              bf.GH[s] + hm, Hw, bf.GHID[s] + hm, Hw), gr, G));
      gh.push_back(gated(prob({seg(bf.GM + sp, STC, w2i, nlc, nlc, true, -1.f)}, H, EPI_GATED,
                              bf.GH[s] + hm + H, Hw, bf.GHID[s] + hm + H, Hw), gi, G));
    }
  }
  if ((err = launch_products(bf.en, gh, st)) != cudaSuccess) return err;

  {
    const long long n = D.E * G;
    const unsigned blocks = (unsigned)std::min<long long>((n + 255) / 256, 4096);
    escn_gate_grad_kernel<<<dim3(blocks, 2), 256, 0, st>>>(bf.GH[0], bf.GH[1], bf.Hd[0], bf.Hd[1],
                                                          bf.Z[0], bf.Z[1], bf.n_rows, H, D.M);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  float* const* gz = bf.Z;  // now the gate pre-activation cotangents

  // gxe = sum over streams of gz_s wg_s^T, scattered onto the pair lattice
  NNProb pxe = prob({seg(gz[0], G, ws[0].wg, G, G, true), seg(gz[1], G, ws[1].wg, G, G, true)},
                    D.EC, EPI_STORE, gxe, D.EC);
  pxe.scatter = 1;
  if ((err = launch_products(bf.en, {pxe}, st)) != cudaSuccess) return err;

  // weight gradients, one launch per stream
  for (int s = 0; s < 2; ++s) {
    float* gwg = gw[0] + s * (long long)D.EC * G;
    float* gbg = gw[1] + s * (long long)G;
    float* g10 = gw[2] + s * (long long)n0 * H;
    float* g20 = gw[3] + s * (long long)H * n0;
    const float* F = bf.F[s];
    std::vector<TNProb> tp;
    tp.push_back(tprob({TSeg{xe, gz[s], D.EC, G, 1.f}}, A_GATHER, D.EC, G, gwg, G));
    tp.push_back(tprob({TSeg{nullptr, gz[s], 0, G, 1.f}}, A_ONES, 1, G, gbg, G));
    tp.push_back(tprob({TSeg{F, bf.GHID[s], STC, Hw, 1.f}}, A_ROWS, n0, H, g10, H));
    tp.push_back(tprob({TSeg{bf.Hg[s], bf.GM, Hw, STC, 1.f}}, A_ROWS, H, n0, g20, n0));
    for (int m = 1; m <= D.M; ++m) {
      const int nlc = D.nl(m) * C, sp = D.span_p(m) * C, sm = D.span_m(m) * C;
      const int hp = D.hp(m), hm = D.hm(m);
      float* gfc1 = gw[4 + 3 * (m - 1)] + s * (long long)nlc * 2 * H;
      float* gw2r = gw[5 + 3 * (m - 1)] + s * (long long)H * nlc;
      float* gw2i = gw[6 + 3 * (m - 1)] + s * (long long)H * nlc;
      tp.push_back(tprob({TSeg{F + sp, bf.GHID[s] + hp, STC, Hw, 1.f},
                          TSeg{F + sm, bf.GHID[s] + hm, STC, Hw, 1.f}},
                         A_ROWS, nlc, 2 * H, gfc1, 2 * H));
      tp.push_back(tprob({TSeg{bf.Hg[s] + hp, bf.GM + sp, Hw, STC, 1.f},
                          TSeg{bf.Hg[s] + hm, bf.GM + sm, Hw, STC, 1.f}},
                         A_ROWS, H, nlc, gw2r, nlc));
      tp.push_back(tprob({TSeg{bf.Hg[s] + hp + H, bf.GM + sm, Hw, STC, 1.f},
                          TSeg{bf.Hg[s] + hm + H, bf.GM + sp, Hw, STC, -1.f}},
                         A_ROWS, H, nlc, gw2i, nlc));
    }
    if ((err = launch_wgrads(bf.en, tp, st)) != cudaSuccess) return err;
  }

  // the rotated stacks' cotangents, in place of the stacks (spent by the weight gradients)
  std::vector<NNProb> gf;
  for (int s = 0; s < 2; ++s) {
    float* F = bf.F[s];
    gf.push_back(prob({seg(bf.GHID[s], Hw, ws[s].w10, H, H, true)}, n0, EPI_STORE, F, STC));
    for (int m = 1; m <= D.M; ++m) {
      const int nlc = D.nl(m) * C;
      gf.push_back(prob({seg(bf.GHID[s] + D.hp(m), Hw, ws[s].fc1[m - 1], 2 * H, 2 * H, true)},
                        nlc, EPI_STORE, F + D.span_p(m) * C, STC));
      gf.push_back(prob({seg(bf.GHID[s] + D.hm(m), Hw, ws[s].fc1[m - 1], 2 * H, 2 * H, true)},
                        nlc, EPI_STORE, F + D.span_m(m) * C, STC));
    }
  }
  if ((err = launch_products(bf.en, gf, st)) != cudaSuccess) return err;

  escn_gx_kernel<L, M><<<D.B * D.A, receiver_threads(D.C), 0, st>>>(bf.F[0], bf.F[1], d, bf.pos,
                                                                     gx, D.A, D.C, D.K);
  return cudaGetLastError();
}

bool supported(int L, int M) { return L == 6 && M == 2; }

int fwd_entry(const float* x, const float* d, const float* xe, const float* const* w,
              const float* tog, const float* fromg, float* out, float* scratch, int* iscratch,
              int B, int A, int C, int H, int EC, int K, int P, int l_max, int m_max, bool rnd,
              void* stream) {
  if (!supported(l_max, m_max) || C % 8 || H % 8 || EC % 8) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  const Dims D = make_dims(B, A, C, H, EC, K, P, l_max, m_max);
  return (int)run_fwd<6, 2>(D, x, d, xe, w, tog, fromg, out, scratch, iscratch, rnd,
                            static_cast<cudaStream_t>(stream));
}

int bwd_entry(const float* x, const float* d, const float* xe, const float* const* w,
              const float* tog, const float* fromg, const float* g, float* gx, float* gxe,
              float* const* gw, float* scratch, int* iscratch, int B, int A, int C, int H, int EC,
              int K, int P, int l_max, int m_max, bool rnd, void* stream) {
  if (!supported(l_max, m_max) || C % 8 || H % 8 || EC % 8) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0 || C == 0) return 0;
  const Dims D = make_dims(B, A, C, H, EC, K, P, l_max, m_max);
  return (int)run_bwd<6, 2>(D, x, d, xe, w, tog, fromg, g, gx, gxe, gw, scratch, iscratch, rnd,
                            static_cast<cudaStream_t>(stream));
}

}  // namespace

extern "C" {

// 1 when the kernels are built for (l_max, m_max), else 0
int escn_supported(int l_max, int m_max) { return supported(l_max, m_max) ? 1 : 0; }

// float and int scratch the wrappers allocate (bwd 0: kernel M, 1: kernel N)
long long escn_scratch_floats(int bwd, int B, int A, int C, int H, int EC, int P, int l_max,
                              int m_max) {
  return scratch_floats(make_dims(B, A, C, H, EC, 0, P, l_max, m_max), bwd != 0);
}

long long escn_scratch_ints(int B, int A) { return scratch_ints(B, A); }

// Each returns a cudaError_t (0 = success), launches on `stream`, does not sync;
// cudaErrorInvalidValue for an (l_max, m_max) the kernels are not built for, or for
// C, H or EC not a multiple of 8. w: the 4 + 3 m_max weight pointers (wg, bg, w1_0, w2_0,
// then fc1, w2r, w2i per m); tog [P, S_t] and fromg [S_t, P] the truncated grid's tables.
int escn_fwd(const float* x, const float* d, const float* xe, const float* const* w,
             const float* tog, const float* fromg, float* out, float* scratch, int* iscratch,
             int B, int A, int C, int H, int EC, int K, int P, int l_max, int m_max,
             void* stream) {
  return fwd_entry(x, d, xe, w, tog, fromg, out, scratch, iscratch, B, A, C, H, EC, K, P, l_max,
                   m_max, false, stream);
}

// escn_fwd in the bf16 mode: every product's operands rounded to bf16
int escn_fwd_bf16(const float* x, const float* d, const float* xe, const float* const* w,
                  const float* tog, const float* fromg, float* out, float* scratch,
                  int* iscratch, int B, int A, int C, int H, int EC, int K, int P, int l_max,
                  int m_max, void* stream) {
  return fwd_entry(x, d, xe, w, tog, fromg, out, scratch, iscratch, B, A, C, H, EC, K, P, l_max,
                   m_max, true, stream);
}

// gw: the gradients' pointers, in the order of w. gxe must hold zeros: only the live
// pairs' rows are written.
int escn_bwd(const float* x, const float* d, const float* xe, const float* const* w,
             const float* tog, const float* fromg, const float* g, float* gx, float* gxe,
             float* const* gw, float* scratch, int* iscratch, int B, int A, int C, int H, int EC,
             int K, int P, int l_max, int m_max, void* stream) {
  return bwd_entry(x, d, xe, w, tog, fromg, g, gx, gxe, gw, scratch, iscratch, B, A, C, H, EC, K,
                   P, l_max, m_max, false, stream);
}

// escn_bwd in the bf16 mode (`_pipeline_bwd` with mxu_bf16: every product's operands,
// the forward's recomputed ones and the transposed and weight-gradient ones, rounded)
int escn_bwd_bf16(const float* x, const float* d, const float* xe, const float* const* w,
                  const float* tog, const float* fromg, const float* g, float* gx, float* gxe,
                  float* const* gw, float* scratch, int* iscratch, int B, int A, int C, int H,
                  int EC, int K, int P, int l_max, int m_max, void* stream) {
  return bwd_entry(x, d, xe, w, tog, fromg, g, gx, gxe, gw, scratch, iscratch, B, A, C, H, EC, K,
                   P, l_max, m_max, true, stream);
}

}  // extern "C"
