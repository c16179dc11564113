// Fused SchNet continuous-filter convolution kernels for Hopper (sm_90a).
//
// The filter of every pair is a two-layer MLP on its radial basis row:
//   z1 = rbf @ W1 + b1      h = ssp(z1) = softplus(z1) - log 2
//   wmr = h @ W2 + b2       wm = wmr * envf           msg_i = sum_j wm[i,j] * xin_j
// with W1 [R,F], W2 [F,F], b1/b2 [F]; envf is the cosine cutoff times the
// adjacency (zero off the edges) and rbf is NOT masked.
//
// Kernel E, schnet_fwd_kernel, replaces nabladft_tpu/ops/pallas/schnet_fused.py
// `_fwd_kernel` (launched by `_run_fwd`'s pallas_call). Kernel F, schnet_bwd, replaces
// `_bwd_kernel` (`_run_bwd`): the VJP of E, with the radial chain folded into g_dist through
// rbfp = d rbf / d dist and envp = d envf / d dist. Kernel G, schnet_dual_fwd_kernel,
// replaces `_dual_fwd_kernel` (`_run_dual_fwd`): E and its tangent along
// (rbfd, envfd, xind) with the weights fixed. Kernel H, schnet_dual_bwd, replaces
// `_dual_bwd_kernel` (`_run_dual_bwd`): the VJP of G for the node inputs and the weights only.
//
// Layouts (as the JAX op): rbf, rbfp, rbfd [B,A,A,R]; envf, envp, envfd [B,A,A];
// xin, xind, msg, gmsg [B,A,F]; all float32, contiguous.
//
// E and G, fp32 FMA on the CUDA cores: per live pair E does an [R]x[R,F] and an [F]x[F,F]
// product (2RF + 2F^2 FMAs), G twice that; at B=64, A=48, R=100, F=128 E needs ~8 GFLOP
// against ~0.07 GB of traffic. One block per (molecule b, receiver i) owns msg_i, a sum over
// senders j, with no atomics. The block compacts the live senders (envf, or envfd for G,
// nonzero: only there is the message nonzero, since rbf is not masked), stages their rbf rows
// in shared memory, forms h for every live pair into shared memory (the second product needs
// all F channels of h before any output channel exists), then h @ W2 folded straight into
// msg. Each thread owns one channel and blocks of 8 rows in registers, so one weight load
// (__ldg, L1/L2 resident) feeds 8 FMAs.
//
// F and H, the filter-MLP products on the tensor cores over the live pairs only. Their outputs
// are sums over receivers i for a fixed sender j (gxin; H's gxind), a sum over channels per
// pair (F's g_dist) and the weight gradients, sums over every pair. So:
//   * schnet_flags_kernel marks slot (b, j, i) live when envf[b,i,j] or the second envelope
//     lane (envp in F, envfd in H) is not zero; a dead pair adds exact zeros to every output.
//     (The rbf row cannot tell: it is not masked, and b1, b2 make every row's MLP nonzero.)
//     so2_common.cuh's live_rows lists the live slots in that sender order with each sender's
//     first row, and so2_pair_rows_kernel maps them to their pair rows (b, i, j).
//   * The products run on so2_common.cuh's engine (3xTF32 wgmma, fp32-accurate) into compact
//     [live, F] rows, persistent (K = R or F is a few k tiles): z1 = rbf W1 + b1 and the second
//     lane a2 W1 (F: rpw = rbfp W1; H: z1d = rbfd W1) over the gathered rows; after
//     schnet_ssp_kernel (s, h and H's hd = s z1d), wmr = h W2 + b2 (H: and wmrd = hd W2).
//   * A stage on the CUDA cores, one block per (b, sender j) and a thread per channel, walks
//     j's live receivers, reads each pair's product rows once with the receiver's cotangents,
//     sums gxin_j (gxind_j) in registers (no partials, no atomics) and overwrites the rows by
//     the cotangents of wmr (and wmrd). F's per-pair sum g_env = sum_f gwm wmr is reduced over
//     each warp by a transposing shuffle and over the warps through shared memory.
//   * gh = cot(wmr) W2^T on the engine (B transposed). F: gz1 = gh s by the gate epilogue, in
//     place over s; g_dist = sum_f gz1 rpw + g_env envp, a warp a live pair
//     (schnet_gdist_kernel; the caller's zeros stay in the dead slots). H: ghd = cot(wmrd) W2^T
//     too, then gz1 = gh s + ghd (1 - s) hd and gz1d = ghd s (schnet_dual_gz1_kernel).
//   * gW1 = rbf_live^T gz1 (H: + rbfd_live^T gz1d) and gW2 = h^T cot(wmr) (H: + hd^T
//     cot(wmrd)) are the engine's weight-gradient products over the live rows, as fixed-order
//     partials over a split of the rows sized from the shapes; gb1 and gb2, the column sums of
//     gz1 and cot(wmr), are schnet_colsum_kernel's chunk partials, summed in order. F and H give
//     the same bits on every run. These run only when a weight asks for its gradient (never on
//     the predict path or in a force pass).
// The rows are reused in place (z1 -> s -> gz1, wmr -> cot(wmr)), so a call's scratch is four
// [B*A*A, F] arrays for F and five for H (schnet_bwd_scratch_floats). The engine takes K and N
// multiples of 4 with 16-byte aligned rows: the entry points take R and F multiples of 4, which
// the wrapper provides by zero padding (schnet.yaml's R = 100, F = 128 need none).

#include <cuda_runtime.h>

#include "so2_common.cuh"

namespace {

constexpr int NT = 256;          // threads per block (E and G)
constexpr int FT = 128;          // channel lanes per block
constexpr int GROUPS = NT / FT;  // row groups sharing a channel lane (2)
constexpr int JB = 8;            // rows per register block

constexpr float LOG2F = 0.6931471805599453f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows padded so each of the GROUPS row groups holds whole JB blocks
__host__ __device__ inline int padded_rows(int a) { return round_up(a, JB * GROUPS); }

// softplus(x) - log 2 (as jax.nn.softplus: max(x,0) + log1p(exp(-|x|))) and
// sigmoid(x), both from one exp
__device__ inline void ssp_sigmoid(float x, float& h, float& s) {
  const float e = expf(-fabsf(x));
  h = fmaxf(x, 0.f) + log1pf(e) - LOG2F;
  s = (x >= 0.f ? 1.f : e) / (1.f + e);
}

// acc[q] += sum_k rows[(row0+q)*ld + k] * wcol[k*ldw]   for q < JB; ld % 4 == 0,
// rows zero padded for k in [K, ld)
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

// two row sets against one weight column (one load feeds both)
__device__ inline void row_block_dot2(const float* __restrict__ rows,
                                      const float* __restrict__ rows2, int row0, int ld, int K,
                                      const float* __restrict__ wcol, int ldw, float acc[JB],
                                      float acc2[JB]) {
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
      const float4 y = *reinterpret_cast<const float4*>(rows2 + (size_t)(row0 + q) * ld + k);
      acc2[q] = fmaf(y.x, w0, acc2[q]);
      acc2[q] = fmaf(y.y, w1, acc2[q]);
      acc2[q] = fmaf(y.z, w2, acc2[q]);
      acc2[q] = fmaf(y.w, w3, acc2[q]);
    }
  }
}

// Warp 0 compacts the live entries of one pair row or column, in order:
// entry t (t < A) sits at env[t * stride] (and env2[t * stride]); live where
// either is nonzero. Writes live_s[k] = t, e_s[k], e2_s[k], kof_s[t] (the
// compact index, -1 when dead) and *n_live.
__device__ inline void compact_live(const float* __restrict__ env, const float* __restrict__ env2,
                                    int A, int stride, int* live_s, float* e_s, float* e2_s,
                                    int* kof_s, int* n_live) {
  const int lane = threadIdx.x;
  if (lane >= 32) return;
  int count = 0;
  for (int t0 = 0; t0 < A; t0 += 32) {
    const int t = t0 + lane;
    const float e = t < A ? env[(size_t)t * stride] : 0.f;
    const float e2 = t < A ? env2[(size_t)t * stride] : 0.f;
    const bool live = e != 0.f || e2 != 0.f;
    const unsigned m = __ballot_sync(0xffffffffu, live);
    const int k = count + __popc(m & ((1u << lane) - 1u));
    if (live) {
      live_s[k] = t;
      e_s[k] = e;
      e2_s[k] = e2;
    }
    if (t < A) kof_s[t] = live ? k : -1;
    count += __popc(m);
  }
  if (lane == 0) *n_live = count;
}

// zero the pad columns [F, Fp) of rows [0, nLp) of an [.][Fp] tile
__device__ inline void zero_pad_cols(float* t, int nLp, int F, int Fp) {
  const int w = Fp - F;
  if (w == 0) return;
  for (int idx = threadIdx.x; idx < nLp * w; idx += blockDim.x)
    t[(size_t)(idx / w) * Fp + F + idx % w] = 0.f;
}

// The shared-memory carve-up of kernels E and G, for L lanes (E 1, G 2: the primal and the
// tangent):
//   [X: L [Ap][Rp] rbf tiles x0, x1][T: L [Ap][Fp] tiles t0, t1 of h][e_s][e2_s][live_s]
//   [kof_s][red: [GROUPS-1][2][FT] node slots]
constexpr int LANES_E = 1, LANES_G = 2;

struct Smem {
  float *x0, *x1, *t0, *t1, *e_s, *e2_s, *red;
  int *live_s, *kof_s;
};

__host__ __device__ inline size_t smem_bytes(int A, int R, int F, int L) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4), Fp = round_up(F, 4);
  return sizeof(float) * ((size_t)L * Ap * (Rp + Fp) + 4 * (size_t)Ap +
                          (size_t)(GROUPS - 1) * 2 * FT);
}

__device__ inline Smem carve(float* smem, int A, int R, int F, int L) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4), Fp = round_up(F, 4);
  Smem s;
  s.x0 = smem;
  s.x1 = smem + (size_t)(L - 1) * Ap * Rp;
  float* p = smem + (size_t)L * Ap * Rp;
  s.t0 = p;
  s.t1 = p + (size_t)(L - 1) * Ap * Fp;
  p += (size_t)L * Ap * Fp;
  s.e_s = p;
  s.e2_s = s.e_s + Ap;
  s.live_s = reinterpret_cast<int*>(s.e2_s + Ap);
  s.kof_s = s.live_s + Ap;
  s.red = reinterpret_cast<float*>(s.kof_s + Ap);
  return s;
}

// stage the rbf rows (and a second set) of the live pairs, compacted and zero
// padded to nLp rows; row k comes from base + live_s[k] * rstride
__device__ inline void stage_rows(const float* __restrict__ src, const float* __restrict__ src2,
                                  size_t base, size_t rstride, const int* live_s, int nL, int nLp,
                                  int R, int Rp, float* dst, float* dst2) {
  for (int idx = threadIdx.x; idx < nLp * Rp; idx += blockDim.x) {
    const int k = idx / Rp, r = idx - k * Rp;
    const bool in = k < nL && r < R;
    const size_t at = base + (size_t)(in ? live_s[k] : 0) * rstride + r;
    dst[idx] = in ? src[at] : 0.f;
    if (src2 != nullptr) dst2[idx] = in ? src2[at] : 0.f;
  }
}

// sum GROUPS partial values of NV accumulators per channel lane: group 0
// ends with the totals; call with every thread of the block
template <int NV>
__device__ inline void group_reduce(float (&acc)[NV], float* red, int fl, int grp) {
  if (grp > 0) {
#pragma unroll
    for (int t = 0; t < NV; ++t) red[((size_t)(grp - 1) * NV + t) * FT + fl] = acc[t];
  }
  __syncthreads();
  if (grp == 0) {
    for (int g = 1; g < GROUPS; ++g)
#pragma unroll
      for (int t = 0; t < NV; ++t) acc[t] += red[((size_t)(g - 1) * NV + t) * FT + fl];
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// kernel E: one block per (molecule b, receiver i)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) schnet_fwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ envf, const float* __restrict__ xin,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ msg, int A, int R, int F) {
  extern __shared__ float4 smem4[];
  __shared__ int n_live;
  const Smem sm = carve(reinterpret_cast<float*>(smem4), A, R, F, LANES_E);
  const int Rp = round_up(R, 4), Fp = round_up(F, 4);
  const int bi = blockIdx.x, b = bi / A, tid = threadIdx.x;

  compact_live(envf + (size_t)bi * A, envf + (size_t)bi * A, A, 1, sm.live_s, sm.e_s, sm.e2_s,
               sm.kof_s, &n_live);
  __syncthreads();
  const int nL = n_live, nLp = padded_rows(nL);
  stage_rows(rbf, nullptr, (size_t)bi * A * R, R, sm.live_s, nL, nLp, R, Rp, sm.x0, nullptr);
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT, rows = nLp / GROUPS;
  float* h_s = sm.t0;  // [nLp][Fp]
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b1[f] : 0.f;
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = 0.f;
      row_block_dot(sm.x0, k0, Rp, R, w1 + (active ? f : 0), F, acc);
      if (!active) continue;
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        float h, s;
        ssp_sigmoid(acc[q] + bias, h, s);
        h_s[(size_t)(k0 + q) * Fp + f] = h;
      }
    }
  }
  zero_pad_cols(h_s, nLp, F, Fp);
  __syncthreads();

  const float* xb = xin + (size_t)b * A * F;
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b2[f] : 0.f;
    float m[1] = {0.f};
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = 0.f;
      row_block_dot(h_s, k0, Fp, F, w2 + (active ? f : 0), F, acc);
      if (!active) continue;
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int k = k0 + q;
        if (k >= nL) continue;
        const float wm = (acc[q] + bias) * sm.e_s[k];
        m[0] = fmaf(wm, xb[(size_t)sm.live_s[k] * F + f], m[0]);
      }
    }
    group_reduce<1>(m, sm.red, fl, grp);
    if (grp == 0 && active) msg[(size_t)bi * F + f] = m[0];
  }
}

// ---------------------------------------------------------------------------
// kernel G: dual forward, one block per (molecule b, receiver i)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) schnet_dual_fwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfd, const float* __restrict__ envf,
    const float* __restrict__ envfd, const float* __restrict__ xin, const float* __restrict__ xind,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ msg, float* __restrict__ msgd, int A, int R,
    int F) {
  extern __shared__ float4 smem4[];
  __shared__ int n_live;
  const Smem sm = carve(reinterpret_cast<float*>(smem4), A, R, F, LANES_G);
  const int Rp = round_up(R, 4), Fp = round_up(F, 4);
  const int bi = blockIdx.x, b = bi / A, tid = threadIdx.x;

  compact_live(envf + (size_t)bi * A, envfd + (size_t)bi * A, A, 1, sm.live_s, sm.e_s, sm.e2_s,
               sm.kof_s, &n_live);
  __syncthreads();
  const int nL = n_live, nLp = padded_rows(nL);
  stage_rows(rbf, rbfd, (size_t)bi * A * R, R, sm.live_s, nL, nLp, R, Rp, sm.x0, sm.x1);
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT, rows = nLp / GROUPS;
  float* h_s = sm.t0;   // [nLp][Fp] h = ssp(z1)
  float* hd_s = sm.t1;  // [nLp][Fp] hd = s * z1d, z1d = rbfd @ W1
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b1[f] : 0.f;
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB], accd[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = accd[q] = 0.f;
      row_block_dot2(sm.x0, sm.x1, k0, Rp, R, w1 + (active ? f : 0), F, acc, accd);
      if (!active) continue;
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        float h, s;
        ssp_sigmoid(acc[q] + bias, h, s);
        h_s[(size_t)(k0 + q) * Fp + f] = h;
        hd_s[(size_t)(k0 + q) * Fp + f] = s * accd[q];
      }
    }
  }
  zero_pad_cols(h_s, nLp, F, Fp);
  zero_pad_cols(hd_s, nLp, F, Fp);
  __syncthreads();

  const float* xb = xin + (size_t)b * A * F;
  const float* xdb = xind + (size_t)b * A * F;
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b2[f] : 0.f;
    float m[2] = {0.f, 0.f};  // msg, msgd
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB], accd[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = accd[q] = 0.f;
      row_block_dot2(h_s, hd_s, k0, Fp, F, w2 + (active ? f : 0), F, acc, accd);
      if (!active) continue;
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int k = k0 + q;
        if (k >= nL) continue;
        const size_t nj = (size_t)sm.live_s[k] * F + f;
        const float wmr = acc[q] + bias;
        const float wm = wmr * sm.e_s[k];
        const float wmd = fmaf(accd[q], sm.e_s[k], wmr * sm.e2_s[k]);
        m[0] = fmaf(wm, xb[nj], m[0]);
        m[1] = fmaf(wmd, xb[nj], fmaf(wm, xdb[nj], m[1]));
      }
    }
    group_reduce<2>(m, sm.red, fl, grp);
    if (grp == 0 && active) {
      msg[(size_t)bi * F + f] = m[0];
      msgd[(size_t)bi * F + f] = m[1];
    }
  }
}

// ---------------------------------------------------------------------------
// kernels F and H: the live pairs in sender order
// ---------------------------------------------------------------------------

// flags[(b*A + j)*A + i] = 1 when envf[b,i,j] or env2[b,i,j] (envp in F, envfd in H) is not
// zero: a thread a pair, in pair order
__global__ void schnet_flags_kernel(const float* __restrict__ env, const float* __restrict__ env2,
                                    int* __restrict__ flags, int A, long long npairs) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npairs) return;
  const long long bi = p / A, b = bi / A;
  const int j = (int)(p - bi * A), i = (int)(bi - b * A);
  flags[(b * A + j) * A + i] = env[p] != 0.f || env2[p] != 0.f;
}

// Over the live rows (n_rows x ld, float4 at a time): z = z1 becomes s = sigmoid(z1) in place
// and h = ssp(z1) is written; with zd (H), z1d becomes hd = s z1d in place.
__global__ void __launch_bounds__(256) schnet_ssp_kernel(float* __restrict__ z,
                                                         float* __restrict__ h,
                                                         float* __restrict__ zd,
                                                         const int* __restrict__ n_rows, int ld) {
  const long long n4 = (long long)*n_rows * ld / 4;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += (long long)gridDim.x * blockDim.x) {
    const float4 zv = reinterpret_cast<const float4*>(z)[q];
    float4 hv, sv;
    ssp_sigmoid(zv.x, hv.x, sv.x);
    ssp_sigmoid(zv.y, hv.y, sv.y);
    ssp_sigmoid(zv.z, hv.z, sv.z);
    ssp_sigmoid(zv.w, hv.w, sv.w);
    reinterpret_cast<float4*>(h)[q] = hv;
    reinterpret_cast<float4*>(z)[q] = sv;
    if (zd) {
      float4 d = reinterpret_cast<const float4*>(zd)[q];
      d = make_float4(sv.x * d.x, sv.y * d.y, sv.z * d.z, sv.w * d.w);
      reinterpret_cast<float4*>(zd)[q] = d;
    }
  }
}

// the stages: a thread a channel, F rounded up to whole warps; SMAXT threads at most for the
// register budget of the model's widths, a second instance beyond (up to 1024 channels)
constexpr int SMAXT = 256;
constexpr int FQ = 8;  // F's stage: receivers a thread holds at once (one pair sum each)
constexpr int HQ = 4;  // H's stage

// ---------------------------------------------------------------------------
// kernel F's stage: one block per (molecule b, sender j), over j's live receivers i (rows
// rs[bj] .. rs[bj+1] - 1 of the compact wmr = h W2 + b2, F floats a row), FQ at a time. Per
// pair and channel f, with gwm = gmsg_i xin_j:
//   gxin_j += wmr envf gmsg_i,   g_env = sum_f gwm wmr (into ge[e]),   gwmr = gwm envf
// and gwmr overwrites wmr (each element read and written by one thread).
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT) schnet_bwd_stage_kernel(
    float* __restrict__ w, float* __restrict__ ge, const int* __restrict__ eidx,
    const int* __restrict__ rs, const int* __restrict__ row, const float* __restrict__ envf,
    const float* __restrict__ xin, const float* __restrict__ gmsg, float* __restrict__ gxin,
    int A, int F) {
  extern __shared__ float red[];  // [2][warps][32]: the warps' pair sums, double buffered
  const int bj = blockIdx.x, b = bj / A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5, f = tid;
  const bool act = f < F;
  const float x = act ? xin[(size_t)bj * F + f] : 0.f;
  const int e_lo = rs[bj], e_hi = rs[bj + 1];
  float gx = 0.f;
  for (int e0 = e_lo, it = 0; e0 < e_hi; e0 += FQ, ++it) {
    const int n = min(FQ, e_hi - e0);
    // every load of the FQ receivers first, so that their latencies overlap
    float wv[FQ], gm[FQ], ef[FQ];
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0);
      const int i = eidx[e] % A;
      ef[q] = ok ? envf[row[e]] : 0.f;
      wv[q] = ok && act ? w[(size_t)e * F + f] : 0.f;
      gm[q] = ok && act ? gmsg[((size_t)b * A + i) * F + f] : 0.f;
    }
    float val[FQ];
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      const float gwm = gm[q] * x;
      val[q] = gwm * wv[q];
      gx = fmaf(wv[q] * ef[q], gm[q], gx);
      if (act && q < n) w[(size_t)(e0 + q) * F + f] = gwm * ef[q];
    }
    // the pair sums: each warp's by shuffles, then the warps' in order through shared memory
    const float sum = warp_sums<FQ>(val, lane);
    float* rb = red + (size_t)(it & 1) * nw * 32;
    rb[warp * 32 + lane] = sum;
    __syncthreads();
    if (tid < n) {
      float s = 0.f;
      for (int g = 0; g < nw; ++g) s += rb[g * 32 + tid];
      ge[e0 + tid] = s;
    }
  }
  if (act) gxin[(size_t)bj * F + f] = gx;
}

// g_dist of each live pair, a warp a row: sum_f gz1 rpw (lanes over float4 columns, then a
// butterfly: a fixed order) + g_env envp; the dead slots keep the caller's zeros
__global__ void __launch_bounds__(256) schnet_gdist_kernel(
    const float* __restrict__ gz1, const float* __restrict__ rp, const float* __restrict__ ge,
    const int* __restrict__ row, const int* __restrict__ n_rows, const float* __restrict__ envp,
    float* __restrict__ gdist, int ld) {
  const int lane = threadIdx.x & 31, nr = *n_rows;
  const long long nwarps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long e = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5; e < nr;
       e += nwarps) {
    float acc = 0.f;
    for (int c = 4 * lane; c < ld; c += 128) {
      const float4 a = *reinterpret_cast<const float4*>(gz1 + e * ld + c);
      const float4 r = *reinterpret_cast<const float4*>(rp + e * ld + c);
      acc = fmaf(a.w, r.w, fmaf(a.z, r.z, fmaf(a.y, r.y, fmaf(a.x, r.x, acc))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) {
      const int p = row[e];
      gdist[p] = fmaf(ge[e], envp[p], acc);
    }
  }
}

// ---------------------------------------------------------------------------
// kernel H's stage: one block per (molecule b, sender j), over j's live receivers (rows of
// the compact wmr = h W2 + b2 and wmrd = hd W2), HQ at a time. Per pair and channel, with
// wm = wmr e, wmd = wmrd e + wmr ed (e = envf, ed = envfd of the pair):
//   gxin_j += wm gmsg_i + wmd gmsgd_i,   gxind_j += wm gmsgd_i
// and with need_gw the cotangents of wmr and wmrd overwrite them:
//   cot_wmr = gwm e + gwmd ed,  cot_wmrd = gwmd e,  gwm = gmsg_i xin_j + gmsgd_i xind_j,
//   gwmd = gmsgd_i xin_j
// ---------------------------------------------------------------------------

template <int MAXT>
__global__ void __launch_bounds__(MAXT) schnet_dual_bwd_stage_kernel(
    float* __restrict__ w, float* __restrict__ wd, const int* __restrict__ eidx,
    const int* __restrict__ rs, const int* __restrict__ row, const float* __restrict__ envf,
    const float* __restrict__ envfd, const float* __restrict__ xin,
    const float* __restrict__ xind, const float* __restrict__ gmsg,
    const float* __restrict__ gmsgd, float* __restrict__ gxin, float* __restrict__ gxind,
    int need_gw, int A, int F) {
  const int bj = blockIdx.x, b = bj / A, f = threadIdx.x;
  if (f >= F) return;
  const size_t nj = (size_t)bj * F + f;
  const float x = xin[nj], xd = xind[nj];
  const int e_lo = rs[bj], e_hi = rs[bj + 1];
  float g0 = 0.f, g1 = 0.f;
  for (int e0 = e_lo; e0 < e_hi; e0 += HQ) {
    const int n = min(HQ, e_hi - e0);
    // every load of the HQ receivers first, so that their latencies overlap
    float ev[HQ], edv[HQ], wr[HQ], wdr[HQ], gm[HQ], gmd[HQ];
#pragma unroll
    for (int q = 0; q < HQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0), p = row[e];
      const size_t node = ((size_t)b * A + eidx[e] % A) * F + f;
      ev[q] = ok ? envf[p] : 0.f;
      edv[q] = ok ? envfd[p] : 0.f;
      wr[q] = ok ? w[(size_t)e * F + f] : 0.f;
      wdr[q] = ok ? wd[(size_t)e * F + f] : 0.f;
      gm[q] = ok ? gmsg[node] : 0.f;
      gmd[q] = ok ? gmsgd[node] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < HQ; ++q) {
      const float wm = wr[q] * ev[q];
      const float wmd = fmaf(wdr[q], ev[q], wr[q] * edv[q]);
      g0 = fmaf(wm, gm[q], fmaf(wmd, gmd[q], g0));
      g1 = fmaf(wm, gmd[q], g1);
      if (need_gw && q < n) {
        const float gwm = fmaf(gm[q], x, gmd[q] * xd), gwmd = gmd[q] * x;
        w[(size_t)(e0 + q) * F + f] = fmaf(gwm, ev[q], gwmd * edv[q]);
        wd[(size_t)(e0 + q) * F + f] = gwmd * ev[q];
      }
    }
  }
  gxin[nj] = g0;
  gxind[nj] = g1;
}

// H's gz1 over the live rows: gz1 = gh s + ghd (1 - s) hd (= ghd s(1 - s) z1d, hd = s z1d)
// over gh, and gz1d = ghd s over ghd
__global__ void __launch_bounds__(256) schnet_dual_gz1_kernel(
    const float* __restrict__ s, const float* __restrict__ hd, float* __restrict__ gh,
    float* __restrict__ ghd, const int* __restrict__ n_rows, int ld) {
  const long long n = (long long)*n_rows * ld;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x; q < n;
       q += (long long)gridDim.x * blockDim.x) {
    const float sv = s[q], g = gh[q], gd = ghd[q];
    gh[q] = fmaf(g, sv, gd * ((1.f - sv) * hd[q]));
    ghd[q] = gd * sv;
  }
}

// The bias gradients: out_p[f] = sum over the live rows e of rows_p[e, f] for the np (<= 2)
// row sets, as CS_CHUNKS partial rows (a block a chunk of rows and a set: float4 columns times
// row lanes, the lanes summed in order through shared memory), then schnet_colsum_reduce_kernel
// sums a column's chunks in order: the same bits every run. (The engine's column sums, a thread
// a column over up to 1/64 of the rows each, take ~5x as long at SchNet's F.)
constexpr int CS_CHUNKS = 128;

struct ColSums {
  const float* rows[2];  // [n_rows, F]
  float* out[2];         // [F]
  int np;
};

__global__ void __launch_bounds__(256) schnet_colsum_kernel(const ColSums cs,
                                                            const int* __restrict__ n_rows,
                                                            float* __restrict__ part, int F) {
  __shared__ float4 red[256];
  const int p = blockIdx.y, c = blockIdx.x, t = threadIdx.x;
  const int G = F / 4, lanes = 256 / G, cg = t % G, rl = t / G;
  const int nr = *n_rows, chunk = (nr + CS_CHUNKS - 1) / CS_CHUNKS;
  const int lo = min(nr, c * chunk), hi = min(nr, lo + chunk);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (rl < lanes) {
    const float4* col = reinterpret_cast<const float4*>(cs.rows[p]) + cg;
    for (int e = lo + rl; e < hi; e += lanes) {
      const float4 v = col[(long long)e * G];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
  }
  red[t] = s;
  __syncthreads();
  if (t < G) {
    for (int l = 1; l < lanes; ++l) {
      const float4 v = red[l * G + t];
      s = make_float4(s.x + v.x, s.y + v.y, s.z + v.z, s.w + v.w);
    }
    reinterpret_cast<float4*>(part + ((long long)p * CS_CHUNKS + c) * F)[t] = s;
  }
}

__global__ void __launch_bounds__(256) schnet_colsum_reduce_kernel(const ColSums cs,
                                                                   const float* __restrict__ part,
                                                                   int F) {
  const int p = blockIdx.y, f = blockIdx.x * blockDim.x + threadIdx.x;
  if (f >= F) return;
  float s = 0.f;
#pragma unroll 8
  for (int c = 0; c < CS_CHUNKS; ++c) s += part[((long long)p * CS_CHUNKS + c) * F + f];
  cs.out[p][f] = s;
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// F and H on the host: the live pairs, the filter-MLP products and gW on the engine
// ---------------------------------------------------------------------------

// what a call carves from its scratch: rows x ld arrays (F: z, z2, h, w; H: all five)
struct Work {
  float *z, *z2, *h, *w, *w2;  // see the stages in schnet_bwd / schnet_dual_bwd
  float* ge;                   // F: g_env of each live row
  float* cs;                   // the bias sums' partials [2][CS_CHUNKS][F]
  int *flags, *eidx, *pos, *row, *rs, *n_rows;
  Engine en;
};

enum { KIND_F = 0, KIND_H = 1 };

long long pair_rows(int B, int A) { return (long long)B * A * A; }
int n_arrays(int kind) { return kind == KIND_F ? 4 : 5; }

// the weight-gradient products of a call (the biases are schnet_colsum_kernel's): F one launch
// (gW1 and gW2 together), H two (gW2, then gW1); pointers null to size the partials
std::vector<std::vector<TNProb>> wgrad_launches(int kind, const Work& w, const float* a1,
                                                const float* a2, float* gw, int R, int F) {
  float* gw2 = gw ? gw + (long long)(R + 1) * F : nullptr;
  if (kind == KIND_F) {
    return {{tprob({TSeg{a1, w.z, R, F, 1.f}}, A_GATHER, R, F, gw, F),
             tprob({TSeg{w.h, w.w, F, F, 1.f}}, A_ROWS, F, F, gw2, F)}};
  }
  return {{tprob({TSeg{w.h, w.w, F, F, 1.f}, TSeg{w.z2, w.w2, F, F, 1.f}}, A_ROWS, F, F, gw2, F)},
          {tprob({TSeg{a1, w.h, R, F, 1.f}, TSeg{a2, w.w, R, F, 1.f}}, A_GATHER, R, F, gw, F)}};
}

// gb1 (row R of gw) and gb2 (row R + 1 + F) as the column sums of rows1 and rows2 (either null)
cudaError_t bias_sums(const Work& w, const float* rows1, const float* rows2, float* gw, int R,
                      int F, cudaStream_t st) {
  ColSums cs{};
  if (rows1) {
    cs.rows[cs.np] = rows1;
    cs.out[cs.np++] = gw + (long long)R * F;
  }
  if (rows2) {
    cs.rows[cs.np] = rows2;
    cs.out[cs.np++] = gw + (long long)(R + 1 + F) * F;
  }
  schnet_colsum_kernel<<<dim3(CS_CHUNKS, cs.np), 256, 0, st>>>(cs, w.n_rows, w.cs, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  schnet_colsum_reduce_kernel<<<dim3((F + 255) / 256, cs.np), 256, 0, st>>>(cs, w.cs, F);
  return cudaGetLastError();
}

long long part_floats(int kind, long long rows, int R, int F) {
  long long need = 0;
  for (const auto& probs : wgrad_launches(kind, Work{}, nullptr, nullptr, nullptr, R, F))
    need = std::max(need, wgrad_part_floats(rows, probs));
  return need;
}

long long prep_floats(int R, int F) { return 2LL * F * std::max(R, F); }

long long scratch_floats(int kind, int B, int A, int R, int F) {
  const long long rows = pair_rows(B, A);
  return n_arrays(kind) * rows * F + prep_floats(R, F) + part_floats(kind, rows, R, F) +
         2LL * CS_CHUNKS * F + (kind == KIND_F ? rows : 0);
}

long long scratch_ints(int B, int A) { return 4 * pair_rows(B, A) + (long long)B * A + 2; }

Work carve_work(int kind, int B, int A, int R, int F, float* f, int* iw) {
  const long long rows = pair_rows(B, A), arr = rows * F;
  Work w{};
  float* p[5] = {};
  for (int q = 0; q < n_arrays(kind); ++q) p[q] = f + q * arr;
  w.z = p[0];
  w.z2 = p[1];
  w.h = p[2];
  w.w = p[3];
  w.w2 = p[4];
  float* prep = f + n_arrays(kind) * arr;
  float* part = prep + prep_floats(R, F);
  w.cs = part + part_floats(kind, rows, R, F);
  w.ge = kind == KIND_F ? w.cs + 2LL * CS_CHUNKS * F : nullptr;
  w.flags = iw;
  w.eidx = iw + rows;
  w.pos = iw + 2 * rows;
  w.row = iw + 3 * rows;
  w.rs = iw + 4 * rows;
  w.n_rows = w.rs + (long long)B * A + 1;
  // the engine gathers the pair rows (b, i, j) of the live slots, listed in sender order
  w.en = Engine{rows, w.n_rows, w.row, prep, prep_floats(R, F), part,
                part_floats(kind, rows, R, F)};
  return w;
}

// the live slots (b, j, i) whose envf or env2 is not zero, in sender order (the engine's
// live_rows over segments of A slots), each sender's first row and the pair rows
cudaError_t live_pairs(const Work& w, const float* envf, const float* env2, int B, int A,
                       cudaStream_t st) {
  const long long rows = pair_rows(B, A);
  const unsigned blocks = (unsigned)((rows + 255) / 256);
  schnet_flags_kernel<<<blocks, 256, 0, st>>>(envf, env2, w.flags, A, rows);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = live_rows(w.flags, w.eidx, w.pos, w.rs, w.n_rows, rows, A, st);
  if (err != cudaSuccess) return err;
  so2_pair_rows_kernel<<<blocks, 256, 0, st>>>(w.eidx, w.n_rows, w.row, A);
  return cudaGetLastError();
}

// blocks of 256 threads for `elems` threads' work, at most 8 an SM (the loops stride)
unsigned row_blocks(long long elems) {
  return (unsigned)std::max(1LL, std::min((elems + 255) / 256, 8LL * SMS));
}

// z1 = a1 W1 + b1 into z and a2 W1 into z2 over the gathered live rows (F: a2 = rbfp, rpw;
// H: a2 = rbfd, z1d); then s, h (and H's hd) by schnet_ssp_kernel
cudaError_t first_layer(const Work& w, const float* a1, const float* a2, const float* w1,
                        const float* b1, int R, int F, bool dual, cudaStream_t st) {
  NNProb p1 = prob({seg(a1, R, w1, F, R)}, F, EPI_GATES, w.z, F);
  NNProb p2 = prob({seg(a2, R, w1, F, R)}, F, EPI_STORE, w.z2, F);
  p1.bias = b1;
  p1.gather = p2.gather = 1;
  cudaError_t err = launch_products(w.en, {p1, p2}, st, true);
  if (err != cudaSuccess) return err;
  schnet_ssp_kernel<<<row_blocks(w.en.max_rows * F / 4), 256, 0, st>>>(
      w.z, w.h, dual ? w.z2 : nullptr, w.n_rows, F);
  return cudaGetLastError();
}

bool shapes_ok(int B, int A, int R, int F) {
  return R > 0 && R % 4 == 0 && F > 0 && F % 4 == 0 && F <= 1024 &&
         pair_rows(B, A) < (1LL << 31);
}

template <typename K1, typename K2, typename Launch>
cudaError_t run_stage(K1 small, K2 large, int F, size_t smem, Launch launch) {
  const int threads = round_up(F, 32);
  auto go = [&](auto kernel) {
    cudaError_t e = set_smem(reinterpret_cast<const void*>(kernel), smem);
    return e != cudaSuccess ? e : launch(kernel, threads);
  };
  return threads <= SMAXT ? go(small) : go(large);
}

size_t bwd_stage_smem(int F) { return sizeof(float) * 2 * (size_t)round_up(F, 32); }

}  // namespace

extern "C" {

// Dynamic shared memory per block of kernel `which` (0 E, 1 F's stage, 2 G, 3 H's stage) at
// these sizes, as the launches ask for it; -1 for an unknown kernel.
int schnet_smem_bytes(int which, int A, int R, int F) {
  switch (which) {
    case 0: return (int)smem_bytes(A, R, F, LANES_E);
    case 1: return (int)bwd_stage_smem(F);
    case 2: return (int)smem_bytes(A, R, F, LANES_G);
    case 3: return 0;
    default: return -1;
  }
}

// Each returns a cudaError_t (0 = success), launches on `stream`, does not sync.
int schnet_fwd(const float* rbf, const float* envf, const float* xin, const float* w1,
               const float* b1, const float* w2, const float* b2, float* msg, int B, int A, int R,
               int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  const size_t smem = smem_bytes(A, R, F, LANES_E);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(schnet_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  schnet_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rbf, envf, xin, w1, b1, w2, b2, msg, A, R, F);
  return (int)cudaGetLastError();
}

// float and int scratch of a call of kernel `which` (0 F: schnet_bwd, 1 H: schnet_dual_bwd) on
// B molecules of A atoms with R radial values and F channels
long long schnet_bwd_scratch_floats(int which, int B, int A, int R, int F) {
  return scratch_floats(which, B, A, R, F);
}

long long schnet_bwd_scratch_ints(int B, int A) { return scratch_ints(B, A); }

// Kernels F and H take R and F multiples of 4, F <= 1024 and 16-byte aligned pair tensors (else
// cudaErrorInvalidValue); scratch and iscratch as schnet_bwd_scratch_floats / _ints size them;
// gw [R + 1 + F + 1, F] (gW1, gb1, gW2, gb2) is written only when need_gw != 0.
// Kernel F: gdist [B,A,A] must hold zeros (only live pairs are written).
int schnet_bwd(const float* rbf, const float* rbfp, const float* envf, const float* envp,
               const float* xin, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gmsg, float* gdist, float* gxin, float* gw,
               float* scratch, int* iscratch, int need_gw, int B, int A, int R, int F,
               void* stream) {
  if (!shapes_ok(B, A, R, F) || !aligned16(rbf) || !aligned16(rbfp))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve_work(KIND_F, B, A, R, F, scratch, iscratch);
  cudaError_t err = live_pairs(wk, envf, envp, B, A, st);
  if (err == cudaSuccess) err = first_layer(wk, rbf, rbfp, w1, b1, R, F, false, st);
  if (err == cudaSuccess) {  // wmr = h W2 + b2
    NNProb p = prob({seg(wk.h, F, w2, F, F)}, F, EPI_GATES, wk.w, F);
    p.bias = b2;
    err = launch_products(wk.en, {p}, st, true);
  }
  if (err == cudaSuccess) {
    const size_t smem = bwd_stage_smem(F);
    err = run_stage(schnet_bwd_stage_kernel<SMAXT>, schnet_bwd_stage_kernel<1024>, F, smem,
                    [&](auto kernel, int threads) {
                      kernel<<<B * A, threads, smem, st>>>(wk.w, wk.ge, wk.eidx, wk.rs, wk.row,
                                                           envf, xin, gmsg, gxin, A, F);
                      return cudaGetLastError();
                    });
  }
  if (err == cudaSuccess) {  // gz1 = (gwmr W2^T) s, over s
    const NNProb p = gated(prob({seg(wk.w, F, w2, F, F, true)}, F, EPI_GATED, nullptr, 0, wk.z,
                                F), wk.z, F);
    err = launch_products(wk.en, {p}, st, true);
  }
  if (err == cudaSuccess) {
    schnet_gdist_kernel<<<row_blocks(pair_rows(B, A) * 32), 256, 0, st>>>(
        wk.z, wk.z2, wk.ge, wk.row, wk.n_rows, envp, gdist, F);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !need_gw) return (int)err;
  err = launch_wgrads(wk.en, wgrad_launches(KIND_F, wk, rbf, nullptr, gw, R, F)[0], st);
  return (int)(err != cudaSuccess ? err : bias_sums(wk, wk.z, wk.w, gw, R, F, st));
}

int schnet_dual_fwd(const float* rbf, const float* rbfd, const float* envf, const float* envfd,
                    const float* xin, const float* xind, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* msg, float* msgd, int B, int A, int R,
                    int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  const size_t smem = smem_bytes(A, R, F, LANES_G);
  cudaError_t err = set_smem(reinterpret_cast<const void*>(schnet_dual_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  schnet_dual_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, msg, msgd, A, R, F);
  return (int)cudaGetLastError();
}

// Kernel H: as schnet_bwd (its live pairs are those of envf or envfd).
int schnet_dual_bwd(const float* rbf, const float* rbfd, const float* envf, const float* envfd,
                    const float* xin, const float* xind, const float* w1, const float* b1,
                    const float* w2, const float* b2, const float* gmsg, const float* gmsgd,
                    float* gxin, float* gxind, float* gw, float* scratch, int* iscratch,
                    int need_gw, int B, int A, int R, int F, void* stream) {
  if (!shapes_ok(B, A, R, F) || !aligned16(rbf) || !aligned16(rbfd))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve_work(KIND_H, B, A, R, F, scratch, iscratch);
  cudaError_t err = live_pairs(wk, envf, envfd, B, A, st);
  if (err == cudaSuccess) err = first_layer(wk, rbf, rbfd, w1, b1, R, F, true, st);
  if (err == cudaSuccess) {  // wmr = h W2 + b2, wmrd = hd W2
    NNProb p1 = prob({seg(wk.h, F, w2, F, F)}, F, EPI_GATES, wk.w, F);
    p1.bias = b2;
    const NNProb p2 = prob({seg(wk.z2, F, w2, F, F)}, F, EPI_STORE, wk.w2, F);
    err = launch_products(wk.en, {p1, p2}, st, true);
  }
  if (err == cudaSuccess) {
    err = run_stage(schnet_dual_bwd_stage_kernel<SMAXT>, schnet_dual_bwd_stage_kernel<1024>, F,
                    0, [&](auto kernel, int threads) {
                      kernel<<<B * A, threads, 0, st>>>(wk.w, wk.w2, wk.eidx, wk.rs, wk.row,
                                                        envf, envfd, xin, xind, gmsg, gmsgd,
                                                        gxin, gxind, need_gw, A, F);
                      return cudaGetLastError();
                    });
  }
  if (err != cudaSuccess || !need_gw) return (int)err;
  const auto launches = wgrad_launches(KIND_H, wk, rbf, rbfd, gw, R, F);
  err = launch_wgrads(wk.en, launches[0], st);  // gW2: h, hd, cot(wmr), cot(wmrd)
  if (err == cudaSuccess) err = bias_sums(wk, nullptr, wk.w, gw, R, F, st);  // gb2
  // gh over h (read by gW2 only), then ghd over cot(wmr) (read by gh only)
  if (err == cudaSuccess)
    err = launch_products(wk.en, {prob({seg(wk.w, F, w2, F, F, true)}, F, EPI_STORE, wk.h, F)},
                          st, true);
  if (err == cudaSuccess)
    err = launch_products(wk.en, {prob({seg(wk.w2, F, w2, F, F, true)}, F, EPI_STORE, wk.w, F)},
                          st, true);
  if (err == cudaSuccess) {
    schnet_dual_gz1_kernel<<<row_blocks(pair_rows(B, A) * F), 256, 0, st>>>(
        wk.z, wk.z2, wk.h, wk.w, wk.n_rows, F);
    err = cudaGetLastError();
  }
  if (err == cudaSuccess) err = launch_wgrads(wk.en, launches[1], st);  // gW1: gz1, gz1d
  return (int)(err != cudaSuccess ? err : bias_sums(wk, wk.h, nullptr, gw, R, F, st));  // gb1
}

}  // extern "C"
