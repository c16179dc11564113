// Fused SchNet continuous-filter convolution kernels for Hopper (sm_90a), fp32 FMA.
//
// The filter of every pair is a two-layer MLP on its radial basis row:
//   z1 = rbf @ W1 + b1      h = ssp(z1) = softplus(z1) - log 2
//   wmr = h @ W2 + b2       wm = wmr * envf           msg_i = sum_j wm[i,j] * xin_j
// with W1 [R,F], W2 [F,F], b1/b2 [F]; envf is the cosine cutoff times the
// adjacency (zero off the edges) and rbf is NOT masked.
//
// Kernel E, schnet_fwd_kernel, replaces nabladft_tpu/ops/pallas/schnet_fused.py
// `_fwd_kernel` (launched by `_run_fwd`'s pallas_call). Kernel F,
// schnet_bwd_kernel (+ the weight-gradient kernels below), replaces `_bwd_kernel`
// (`_run_bwd`): the VJP of E, with the radial chain folded into g_dist through
// rbfp = d rbf / d dist and envp = d envf / d dist. Kernel G, schnet_dual_fwd_kernel,
// replaces `_dual_fwd_kernel` (`_run_dual_fwd`): E and its tangent along
// (rbfd, envfd, xind) with the weights fixed. Kernel H, schnet_dual_bwd_kernel
// (+ the weight-gradient kernels), replaces `_dual_bwd_kernel` (`_run_dual_bwd`):
// the VJP of G for the node inputs and the weights only.
//
// Layouts (as the JAX op): rbf, rbfp, rbfd [B,A,A,R]; envf, envp, envfd [B,A,A];
// xin, xind, msg, gmsg [B,A,F]; all float32, contiguous.
//
// What bounds them on the card: per live pair E does an [R]x[R,F] and an
// [F]x[F,F] product (2RF + 2F^2 FMAs), F and G twice that, H with its weight
// gradient four times: at B=64, A=48, R=100, F=128 E needs ~8 GFLOP against
// ~0.07 GB of traffic, so all four are bound by the fp32 FMA rate. The design
// keeps every per-pair [F] vector (z1, h, wmr and their cotangents) out of
// device memory on the paths that need no weight gradient:
//   * E and G: one block per (molecule b, receiver i) owns msg_i, a sum over
//     senders j, with no atomics. The block compacts the live senders (envf,
//     or envfd for G, nonzero: only there is the message nonzero, since rbf is
//     not masked), stages their rbf rows in shared memory, forms h for every
//     live pair into shared memory (the second product needs all F channels of
//     h before any output channel exists), then h @ W2 folded straight into
//     msg. Each thread owns one channel and blocks of 8 rows in registers, so
//     one weight load (__ldg, L1/L2 resident) feeds 8 FMAs.
//   * F and H: gxin_j (and gxind_j) reduce over receivers i, so one block per
//     (molecule b, SENDER j) owns them, as PaiNN's B and D do. F's g_dist needs
//     the cotangent of h, gh = gwmr @ W2^T, a third product per pair; W2^T is
//     formed by a small transpose kernel first. Per-pair channel sums (g_dist)
//     go through warp shuffles into per-warp shared-memory slots, summed in a
//     fixed order: every output has one writer and F and H give the same bits
//     on every run.
//   * The weight gradients (gW1 = sum_pairs rbf^T gz1, gW2 = sum_pairs h^T gwmr,
//     and the biases as the sums of gz1 / gwmr) reduce over all pairs of all
//     molecules: a sequential-grid accumulator on the TPU. Here the main kernel
//     writes h and gz1 (and their tangent-lane twins) for every pair to scratch
//     buffers, a tiled kernel forms one partial per (molecule, pair slice), the
//     bias as an extra row of ones, recomputing gwmr from node tensors, and a
//     reduce kernel sums the partials in a fixed order. They run only when a
//     weight asks for its gradient (never on the predict path or in a force
//     pass).
// In the weight-gradient path the main kernels park s = sigmoid(z1) (and z1d)
// in the gz1 scratch during the first product and read them back in the third:
// the same thread writes and reads each element, so no barrier is needed.
// Plain FMA only: no TF32, no tensor cores (a later step).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;          // threads per block (main kernels)
constexpr int FT = 128;          // channel lanes per block
constexpr int GROUPS = NT / FT;  // row groups sharing a channel lane (2)
constexpr int JB = 8;            // rows per register block
constexpr int NWF = FT / 32;     // warps across the channel lanes (4)

// weight-gradient tiles: 16 x 16 threads, RH row slots and 4 columns each
constexpr int GW_NT = 64;        // output columns per block
constexpr int GW_PT = 16;        // pairs per shared-memory chunk
constexpr int GW_SPLITS = 4;     // pair slices per molecule (partials per molecule)

constexpr float LOG2F = 0.6931471805599453f;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// rows padded so each of the GROUPS row groups holds whole JB blocks
__host__ __device__ inline int padded_rows(int a) { return round_up(a, JB * GROUPS); }

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

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

// The shared-memory carve-up of the four main kernels:
//   [X region][T tiles][e_s][e2_s][live_s][kof_s][red]
// X holds NXR [Ap][Rp] rbf tiles (x0, x1), later overlaid by NXF [Ap][Fp]
// per-pair cotangent tiles; T holds NT_ [Ap][Fp] tiles (t0, t1) of h.
struct Layout {
  int nxr, nxf, nt;
};
__host__ __device__ constexpr Layout LAYOUT_E() { return {1, 0, 1}; }
__host__ __device__ constexpr Layout LAYOUT_F() { return {2, 1, 2}; }
__host__ __device__ constexpr Layout LAYOUT_G() { return {2, 0, 2}; }
__host__ __device__ constexpr Layout LAYOUT_H() { return {2, 2, 2}; }

struct Smem {
  float *x0, *x1, *t0, *t1, *e_s, *e2_s, *red;
  int *live_s, *kof_s;
};

__host__ __device__ inline size_t x_region(int A, int R, int F, Layout L) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4), Fp = round_up(F, 4);
  const size_t a = (size_t)L.nxr * Ap * Rp, b = (size_t)L.nxf * Ap * Fp;
  return a > b ? a : b;
}

// red floats: pair slots [NWF][Ap][2] (F) and node slots [GROUPS-1][2][FT]
__host__ __device__ inline size_t red_floats(int A) {
  return (size_t)NWF * padded_rows(A) * 2 + (size_t)(GROUPS - 1) * 2 * FT;
}

__host__ __device__ inline size_t smem_bytes(int A, int R, int F, Layout L) {
  const int Ap = padded_rows(A), Fp = round_up(F, 4);
  return sizeof(float) * (x_region(A, R, F, L) + (size_t)L.nt * Ap * Fp + 4 * (size_t)Ap +
                          red_floats(A));
}

__device__ inline Smem carve(float* smem, int A, int R, int F, Layout L) {
  const int Ap = padded_rows(A), Rp = round_up(R, 4), Fp = round_up(F, 4);
  Smem s;
  s.x0 = smem;
  s.x1 = smem + (size_t)Ap * Rp;
  float* p = smem + x_region(A, R, F, L);
  s.t0 = p;
  s.t1 = p + (size_t)(L.nt - 1) * Ap * Fp;
  p += (size_t)L.nt * Ap * Fp;
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
  const Smem sm = carve(reinterpret_cast<float*>(smem4), A, R, F, LAYOUT_E());
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
// kernel F: node and pair cotangents, one block per (molecule b, sender j)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) schnet_bwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfp, const float* __restrict__ envf,
    const float* __restrict__ envp, const float* __restrict__ xin, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ w2t, const float* __restrict__ gmsg, float* __restrict__ gdist,
    float* __restrict__ gxin, float* __restrict__ h_buf, float* __restrict__ gz1_buf, int A,
    int R, int F) {
  extern __shared__ float4 smem4[];
  __shared__ int n_live;
  const Smem sm = carve(reinterpret_cast<float*>(smem4), A, R, F, LAYOUT_F());
  const int Ap = padded_rows(A), Rp = round_up(R, 4), Fp = round_up(F, 4);
  const int bj = blockIdx.x, b = bj / A, j = bj - b * A, tid = threadIdx.x;
  const bool need_gw = h_buf != nullptr;
  const size_t col = (size_t)b * A * A + j;  // pair (b, i, j) = col + i * A

  compact_live(envf + col, envp + col, A, A, sm.live_s, sm.e_s, sm.e2_s, sm.kof_s, &n_live);
  __syncthreads();
  const int nL = n_live, nLp = padded_rows(nL);
  stage_rows(rbf, rbfp, col * R, (size_t)A * R, sm.live_s, nL, nLp, R, Rp, sm.x0, sm.x1);
  float* red_pair = sm.red;                        // [NWF][Ap][2]: g_env, g_basis
  float* red_node = sm.red + (size_t)NWF * Ap * 2;  // group_reduce scratch
  for (int idx = tid; idx < NWF * Ap * 2; idx += NT) red_pair[idx] = 0.f;
  if (need_gw) {  // dead pairs: zero rows of the scratch the gW kernels read
    for (int idx = tid; idx < A * F; idx += NT) {
      const int i = idx / F, f = idx - i * F;
      if (sm.kof_s[i] >= 0) continue;
      const size_t at = (col + (size_t)i * A) * F + f;
      h_buf[at] = 0.f;
      gz1_buf[at] = 0.f;
    }
  }
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT, rows = nLp / GROUPS, lane = tid % 32, fw = fl / 32;
  float* h_s = sm.t0;  // [nLp][Fp] h
  float* q_s = sm.t1;  // [nLp][Fp] s * (rbfp @ W1)
  // 1: z1 = rbf @ W1 + b1 and rpw = rbfp @ W1 per live pair
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b1[f] : 0.f;
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB], rp[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = rp[q] = 0.f;
      row_block_dot2(sm.x0, sm.x1, k0, Rp, R, w1 + (active ? f : 0), F, acc, rp);
      if (!active) continue;
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int k = k0 + q;
        float h, s;
        ssp_sigmoid(acc[q] + bias, h, s);
        h_s[(size_t)k * Fp + f] = h;
        q_s[(size_t)k * Fp + f] = s * rp[q];
        if (need_gw && k < nL) {
          const size_t at = (col + (size_t)sm.live_s[k] * A) * F + f;
          h_buf[at] = h;
          gz1_buf[at] = s;  // read back by this thread in step 3
        }
      }
    }
  }
  zero_pad_cols(h_s, nLp, F, Fp);
  __syncthreads();
  // gwmr = gmsg_i * xin_j * envf_ij over the rbf rows, which are no longer needed
  float* gw_s = sm.x0;  // [nLp][Fp]
  const float* xj = xin + ((size_t)b * A + j) * F;
  for (int idx = tid; idx < nLp * Fp; idx += NT) {
    const int k = idx / Fp, f = idx - k * Fp;
    float v = 0.f;
    if (k < nL && f < F) v = gmsg[((size_t)b * A + sm.live_s[k]) * F + f] * xj[f] * sm.e_s[k];
    gw_s[idx] = v;
  }
  __syncthreads();

  // 2: wmr = h @ W2 + b2: gxin_j and g_env_ij = sum_f gmsg_i xin_j wmr
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b2[f] : 0.f, x = active ? xj[f] : 0.f;
    float gx[1] = {0.f};
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB], ge[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = ge[q] = 0.f;
      row_block_dot(h_s, k0, Fp, F, w2 + (active ? f : 0), F, acc);
      if (active) {
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int k = k0 + q;
          if (k >= nL) continue;
          const float wmr = acc[q] + bias;
          const float gm = gmsg[((size_t)b * A + sm.live_s[k]) * F + f];
          gx[0] = fmaf(wmr * sm.e_s[k], gm, gx[0]);
          ge[q] = gm * x * wmr;
        }
      }
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const float t = warp_sum(ge[q]);
        if (lane == 0 && k0 + q < nL) red_pair[((size_t)fw * Ap + k0 + q) * 2] += t;
      }
    }
    group_reduce<1>(gx, red_node, fl, grp);
    if (grp == 0 && active) gxin[(size_t)bj * F + f] = gx[0];
  }

  // 3: gh = gwmr @ W2^T, gz1 = gh * s; g_basis_ij = sum_g gz1 * rpw
  for (int g0 = 0; g0 < F; g0 += FT) {
    const int g = g0 + fl;
    const bool active = g < F;
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float acc[JB], gb[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) acc[q] = gb[q] = 0.f;
      row_block_dot(gw_s, k0, Fp, F, w2t + (active ? g : 0), F, acc);
      if (active) {
#pragma unroll
        for (int q = 0; q < JB; ++q) {
          const int k = k0 + q;
          if (k >= nL) continue;
          gb[q] = acc[q] * q_s[(size_t)k * Fp + g];
          if (need_gw) {
            const size_t at = (col + (size_t)sm.live_s[k] * A) * F + g;
            gz1_buf[at] = acc[q] * gz1_buf[at];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const float t = warp_sum(gb[q]);
        if (lane == 0 && k0 + q < nL) red_pair[((size_t)fw * Ap + k0 + q) * 2 + 1] += t;
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < A; i += NT) {
    const int k = sm.kof_s[i];
    float gd = 0.f;
    if (k >= 0) {
      float ge = 0.f, gbs = 0.f;
      for (int w = 0; w < NWF; ++w) {
        ge += red_pair[((size_t)w * Ap + k) * 2];
        gbs += red_pair[((size_t)w * Ap + k) * 2 + 1];
      }
      gd = gbs + ge * sm.e2_s[k];
    }
    gdist[col + (size_t)i * A] = gd;
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
  const Smem sm = carve(reinterpret_cast<float*>(smem4), A, R, F, LAYOUT_G());
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
// kernel H: node cotangents (and the per-pair gz1 / gz1d for the weight
// gradient), one block per (molecule b, sender j)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT) schnet_dual_bwd_kernel(
    const float* __restrict__ rbf, const float* __restrict__ rbfd, const float* __restrict__ envf,
    const float* __restrict__ envfd, const float* __restrict__ xin, const float* __restrict__ xind,
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ w2t, const float* __restrict__ gmsg,
    const float* __restrict__ gmsgd, float* __restrict__ gxin, float* __restrict__ gxind,
    float* __restrict__ h_buf, float* __restrict__ hd_buf, float* __restrict__ gz1_buf,
    float* __restrict__ gz1d_buf, int A, int R, int F) {
  extern __shared__ float4 smem4[];
  __shared__ int n_live;
  const Smem sm = carve(reinterpret_cast<float*>(smem4), A, R, F, LAYOUT_H());
  const int Ap = padded_rows(A), Rp = round_up(R, 4), Fp = round_up(F, 4);
  const int bj = blockIdx.x, b = bj / A, j = bj - b * A, tid = threadIdx.x;
  const bool need_gw = h_buf != nullptr;
  const size_t col = (size_t)b * A * A + j;  // pair (b, i, j) = col + i * A

  compact_live(envf + col, envfd + col, A, A, sm.live_s, sm.e_s, sm.e2_s, sm.kof_s, &n_live);
  __syncthreads();
  const int nL = n_live, nLp = padded_rows(nL);
  stage_rows(rbf, rbfd, col * R, (size_t)A * R, sm.live_s, nL, nLp, R, Rp, sm.x0, sm.x1);
  if (need_gw) {  // dead pairs: zero rows of the scratch the gW kernels read
    for (int idx = tid; idx < A * F; idx += NT) {
      const int i = idx / F, f = idx - i * F;
      if (sm.kof_s[i] >= 0) continue;
      const size_t at = (col + (size_t)i * A) * F + f;
      h_buf[at] = hd_buf[at] = gz1_buf[at] = gz1d_buf[at] = 0.f;
    }
  }
  __syncthreads();

  const int fl = tid % FT, grp = tid / FT, rows = nLp / GROUPS;
  float* h_s = sm.t0;
  float* hd_s = sm.t1;
  // 1: z1 = rbf @ W1 + b1, z1d = rbfd @ W1; h = ssp(z1), hd = s * z1d
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
        const int k = k0 + q;
        float h, s;
        ssp_sigmoid(acc[q] + bias, h, s);
        const float hd = s * accd[q];
        h_s[(size_t)k * Fp + f] = h;
        hd_s[(size_t)k * Fp + f] = hd;
        if (need_gw && k < nL) {
          const size_t at = (col + (size_t)sm.live_s[k] * A) * F + f;
          h_buf[at] = h;
          hd_buf[at] = hd;
          gz1_buf[at] = s;         // read back by this thread in step 3
          gz1d_buf[at] = accd[q];  // z1d, likewise
        }
      }
    }
  }
  zero_pad_cols(h_s, nLp, F, Fp);
  zero_pad_cols(hd_s, nLp, F, Fp);
  __syncthreads();

  const float* xj = xin + ((size_t)b * A + j) * F;
  const float* xdj = xind + ((size_t)b * A + j) * F;
  float* cw_s = sm.x0;                         // [nLp][Fp] cotangent of wmr
  float* cwd_s = sm.x0 + (size_t)Ap * Fp;      // [nLp][Fp] cotangent of wmrd
  if (need_gw) {  // over the rbf rows, which are no longer needed
    for (int idx = tid; idx < nLp * Fp; idx += NT) {
      const int k = idx / Fp, f = idx - k * Fp;
      float cw = 0.f, cwd = 0.f;
      if (k < nL && f < F) {
        const size_t ni = ((size_t)b * A + sm.live_s[k]) * F + f;
        const float gm = gmsg[ni], gmd = gmsgd[ni];
        const float gwm = fmaf(gm, xj[f], gmd * xdj[f]), gwmd = gmd * xj[f];
        cw = fmaf(gwm, sm.e_s[k], gwmd * sm.e2_s[k]);
        cwd = gwmd * sm.e_s[k];
      }
      cw_s[idx] = cw;
      cwd_s[idx] = cwd;
    }
    __syncthreads();
  }

  // 2: wmr = h @ W2 + b2, wmrd = hd @ W2: gxin_j, gxind_j
  for (int f0 = 0; f0 < F; f0 += FT) {
    const int f = f0 + fl;
    const bool active = f < F;
    const float bias = active ? b2[f] : 0.f;
    float gx[2] = {0.f, 0.f};  // gxin, gxind
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
        const size_t ni = ((size_t)b * A + sm.live_s[k]) * F + f;
        const float gm = gmsg[ni], gmd = gmsgd[ni];
        const float wmr = acc[q] + bias;
        const float wm = wmr * sm.e_s[k];
        const float wmd = fmaf(accd[q], sm.e_s[k], wmr * sm.e2_s[k]);
        gx[0] = fmaf(wm, gm, fmaf(wmd, gmd, gx[0]));
        gx[1] = fmaf(wm, gmd, gx[1]);
      }
    }
    group_reduce<2>(gx, sm.red, fl, grp);
    if (grp == 0 && active) {
      gxin[(size_t)bj * F + f] = gx[0];
      gxind[(size_t)bj * F + f] = gx[1];
    }
  }
  if (!need_gw) return;

  // 3: gh = cw @ W2^T, ghd = cwd @ W2^T; gz1 = gh s + ghd s (1 - s) z1d, gz1d = ghd s
  for (int g0 = 0; g0 < F; g0 += FT) {
    const int g = g0 + fl;
    const bool active = g < F;
    for (int k0 = grp * rows; k0 < (grp + 1) * rows; k0 += JB) {
      float gh[JB], ghd[JB];
#pragma unroll
      for (int q = 0; q < JB; ++q) gh[q] = ghd[q] = 0.f;
      row_block_dot2(cw_s, cwd_s, k0, Fp, F, w2t + (active ? g : 0), F, gh, ghd);
      if (!active) continue;
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int k = k0 + q;
        if (k >= nL) continue;
        const size_t at = (col + (size_t)sm.live_s[k] * A) * F + g;
        const float s = gz1_buf[at], z1d = gz1d_buf[at];
        gz1_buf[at] = fmaf(gh[q], s, ghd[q] * (s * (1.f - s) * z1d));
        gz1d_buf[at] = ghd[q] * s;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// weight gradients: part[b * GW_SPLITS + sp] ([K+1, N]) = sum over the pairs
// of slice sp of molecule b of x1[p]^T y1[p] (+ x2[p]^T y2[p]), with row K the
// bias: x1's implicit column of ones (x2 has none). MODE 0 reads y1 / y2
// from buffers [B, A*A, N]; MODE 1 forms F's y1 = gwmr = gmsg_i xin_j envf_ij;
// MODE 2 forms H's y1 = cot(wmr), y2 = cot(wmrd) from node tensors. Each
// thread accumulates RH rows x 4 columns.
// ---------------------------------------------------------------------------

template <int RH, int MODE>
__global__ void __launch_bounds__(256) schnet_gw_kernel(
    const float* __restrict__ x1, const float* __restrict__ x2, int K, const float* __restrict__ y1,
    const float* __restrict__ y2, const float* __restrict__ gmsg, const float* __restrict__ gmsgd,
    const float* __restrict__ xin, const float* __restrict__ xind, const float* __restrict__ envf,
    const float* __restrict__ envfd, float* __restrict__ part, int A, int N) {
  constexpr int RT = 16 * RH;
  __shared__ float x_s[GW_PT][RT];
  __shared__ float xd_s[GW_PT][RT];
  __shared__ float y_s[GW_PT][GW_NT];
  __shared__ float yd_s[GW_PT][GW_NT];
  const bool two = x2 != nullptr;
  const int n0 = blockIdx.x * GW_NT, r0 = blockIdx.y * RT, z = blockIdx.z;
  const int b = z / GW_SPLITS, sp = z - b * GW_SPLITS;
  const int P = A * A, per = (P + GW_SPLITS - 1) / GW_SPLITS;
  const int p_lo = sp * per, p_hi = min(P, p_lo + per);
  const int tid = threadIdx.x, tr = tid / 16, tn = tid % 16;  // rows tr + 16h, cols tn + 16q
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
      const size_t at = ((size_t)b * P + p) * K + r;
      x_s[pp][rr] = !in ? 0.f : (r < K ? x1[at] : (r == K ? 1.f : 0.f));
      if (two) xd_s[pp][rr] = in && r < K ? x2[at] : 0.f;
    }
    for (int idx = tid; idx < GW_PT * GW_NT; idx += 256) {
      const int pp = idx / GW_NT, nn = idx - pp * GW_NT;
      const int p = p0 + pp, n = n0 + nn;
      float y = 0.f, yd = 0.f;
      if (p < p_hi && n < N) {
        const size_t pair = (size_t)b * P + p;
        if (MODE == 0) {
          y = y1[pair * N + n];
          if (two) yd = y2[pair * N + n];
        } else {
          const int i = p / A, jj = p - i * A;
          const size_t ni = ((size_t)b * A + i) * N + n, nj = ((size_t)b * A + jj) * N + n;
          if (MODE == 1) {
            y = gmsg[ni] * xin[nj] * envf[pair];
          } else {
            const float gm = gmsg[ni], gmd = gmsgd[ni], e = envf[pair];
            const float gwm = fmaf(gm, xin[nj], gmd * xind[nj]), gwmd = gmd * xin[nj];
            y = fmaf(gwm, e, gwmd * envfd[pair]);
            yd = gwmd * e;
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
      for (int h = 0; h < RH; ++h) {
        const float x = x_s[pp][tr + 16 * h];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(x, y[q], acc[h][q]);
        if (two) {
          const float xd = xd_s[pp][tr + 16 * h];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[h][q] = fmaf(xd, yd[q], acc[h][q]);
        }
      }
    }
    __syncthreads();
  }
  float* out = part + (size_t)z * (K + 1) * N;
#pragma unroll
  for (int h = 0; h < RH; ++h) {
    const int r = r0 + tr + 16 * h;
    if (r > K) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = n0 + tn + 16 * q;
      if (n < N) out[(size_t)r * N + n] = acc[h][q];
    }
  }
}

// out[idx] = sum over the nparts partials, in order: the same bits every run
__global__ void schnet_gw_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                        int nparts, int n) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int z = 0; z < nparts; ++z) s += part[(size_t)z * n + idx];
  out[idx] = s;
}

// wt[f][g] = w[g][f]   (W2^T for the products with W2's rows)
__global__ void schnet_transpose_kernel(const float* __restrict__ w, float* __restrict__ wt,
                                        int F) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= F * F) return;
  const int g = idx / F, f = idx - g * F;
  wt[(size_t)f * F + g] = w[idx];
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int RH, int MODE>
cudaError_t launch_gw(const float* x1, const float* x2, int K, const float* y1, const float* y2,
                      const float* gmsg, const float* gmsgd, const float* xin, const float* xind,
                      const float* envf, const float* envfd, float* part, float* out, int B, int A,
                      int N, cudaStream_t s) {
  constexpr int RT = 16 * RH;
  const dim3 grid((N + GW_NT - 1) / GW_NT, (K + 1 + RT - 1) / RT, B * GW_SPLITS);
  schnet_gw_kernel<RH, MODE><<<grid, 256, 0, s>>>(x1, x2, K, y1, y2, gmsg, gmsgd, xin, xind,
                                                  envf, envfd, part, A, N);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n = (K + 1) * N;
  schnet_gw_reduce_kernel<<<(n + 255) / 256, 256, 0, s>>>(part, out, B * GW_SPLITS, n);
  return cudaGetLastError();
}

cudaError_t launch_transpose(const float* w2, float* w2t, int F, cudaStream_t s) {
  schnet_transpose_kernel<<<(F * F + 255) / 256, 256, 0, s>>>(w2, w2t, F);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Partials per molecule of the weight-gradient stage: the wrappers size the
// [B * splits, K + 1, N] scratch by it.
int schnet_gw_splits() { return GW_SPLITS; }

// Dynamic shared memory per block of kernel `which` (0 E, 1 F, 2 G, 3 H) at
// these sizes, as the launches ask for it; -1 for an unknown kernel.
int schnet_smem_bytes(int which, int A, int R, int F) {
  const Layout layouts[4] = {LAYOUT_E(), LAYOUT_F(), LAYOUT_G(), LAYOUT_H()};
  if (which < 0 || which > 3) return -1;
  return (int)smem_bytes(A, R, F, layouts[which]);
}

// Each returns a cudaError_t (0 = success), launches on `stream`, does not sync.
int schnet_fwd(const float* rbf, const float* envf, const float* xin, const float* w1,
               const float* b1, const float* w2, const float* b2, float* msg, int B, int A, int R,
               int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  const size_t smem = smem_bytes(A, R, F, LAYOUT_E());
  cudaError_t err = set_smem(reinterpret_cast<const void*>(schnet_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  schnet_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rbf, envf, xin, w1, b1, w2, b2, msg, A, R, F);
  return (int)cudaGetLastError();
}

// w2t [F,F] scratch always; h_buf, gz1_buf [B,A,A,F], part1 [B*splits,R+1,F],
// part2 [B*splits,F+1,F], gw1b1 [R+1,F] (gW1 over gb1) and gw2b2 [F+1,F]
// (gW2 over gb2) only when need_gw != 0.
int schnet_bwd(const float* rbf, const float* rbfp, const float* envf, const float* envp,
               const float* xin, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gmsg, float* gdist, float* gxin, float* w2t,
               float* h_buf, float* gz1_buf, float* part1, float* part2, float* gw1b1,
               float* gw2b2, int need_gw, int B, int A, int R, int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_transpose(w2, w2t, F, s);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(A, R, F, LAYOUT_F());
  err = set_smem(reinterpret_cast<const void*>(schnet_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  schnet_bwd_kernel<<<B * A, NT, smem, s>>>(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, w2t,
                                            gmsg, gdist, gxin, need_gw ? h_buf : nullptr,
                                            need_gw ? gz1_buf : nullptr, A, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess || !need_gw) return (int)err;
  err = launch_gw<7, 0>(rbf, nullptr, R, gz1_buf, nullptr, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, part1, gw1b1, B, A, F, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gw<9, 1>(h_buf, nullptr, F, nullptr, nullptr, gmsg, nullptr, xin, nullptr,
                              envf, nullptr, part2, gw2b2, B, A, F, s);
}

int schnet_dual_fwd(const float* rbf, const float* rbfd, const float* envf, const float* envfd,
                    const float* xin, const float* xind, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* msg, float* msgd, int B, int A, int R,
                    int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  const size_t smem = smem_bytes(A, R, F, LAYOUT_G());
  cudaError_t err = set_smem(reinterpret_cast<const void*>(schnet_dual_fwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  schnet_dual_fwd_kernel<<<B * A, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, msg, msgd, A, R, F);
  return (int)cudaGetLastError();
}

// the scratch and weight-gradient outputs as in schnet_bwd, with hd_buf and
// gz1d_buf besides; all used only when need_gw != 0
int schnet_dual_bwd(const float* rbf, const float* rbfd, const float* envf, const float* envfd,
                    const float* xin, const float* xind, const float* w1, const float* b1,
                    const float* w2, const float* b2, const float* gmsg, const float* gmsgd,
                    float* gxin, float* gxind, float* w2t, float* h_buf, float* hd_buf,
                    float* gz1_buf, float* gz1d_buf, float* part1, float* part2, float* gw1b1,
                    float* gw2b2, int need_gw, int B, int A, int R, int F, void* stream) {
  if (B == 0 || A == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (need_gw) {
    err = launch_transpose(w2, w2t, F, s);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = smem_bytes(A, R, F, LAYOUT_H());
  err = set_smem(reinterpret_cast<const void*>(schnet_dual_bwd_kernel), smem);
  if (err != cudaSuccess) return (int)err;
  schnet_dual_bwd_kernel<<<B * A, NT, smem, s>>>(
      rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, w2t, gmsg, gmsgd, gxin, gxind,
      need_gw ? h_buf : nullptr, hd_buf, gz1_buf, gz1d_buf, A, R, F);
  err = cudaGetLastError();
  if (err != cudaSuccess || !need_gw) return (int)err;
  err = launch_gw<7, 0>(rbf, rbfd, R, gz1_buf, gz1d_buf, nullptr, nullptr, nullptr, nullptr,
                        nullptr, nullptr, part1, gw1b1, B, A, F, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gw<9, 2>(h_buf, hd_buf, F, nullptr, nullptr, gmsg, gmsgd, xin, xind, envf,
                              envfd, part2, gw2b2, B, A, F, s);
}

}  // extern "C"
