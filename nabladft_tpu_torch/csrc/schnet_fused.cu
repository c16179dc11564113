// Fused SchNet continuous-filter convolution kernels for Hopper (sm_90a).
//
// The filter of every pair is a two-layer MLP on its radial basis row:
//   z1 = rbf @ W1 + b1      h = ssp(z1) = softplus(z1) - log 2
//   wmr = h @ W2 + b2       wm = wmr * envf           msg_i = sum_j wm[i,j] * xin_j
// with W1 [R,F], W2 [F,F], b1/b2 [F]; envf is the cosine cutoff times the
// adjacency (zero off the edges) and rbf is NOT masked.
//
// Kernel E, schnet_fwd, replaces nabladft_tpu/ops/pallas/schnet_fused.py `_fwd_kernel`
// (launched by `_run_fwd`'s pallas_call). Kernel F, schnet_bwd, replaces `_bwd_kernel`
// (`_run_bwd`): the VJP of E, with the radial chain folded into g_dist through rbfp = d rbf /
// d dist and envp = d envf / d dist. Kernel G, schnet_dual_fwd, replaces `_dual_fwd_kernel`
// (`_run_dual_fwd`): E and its tangent along (rbfd, envfd, xind) with the weights fixed.
// Kernel H, schnet_dual_bwd, replaces `_dual_bwd_kernel` (`_run_dual_bwd`): the VJP of G for
// the node inputs and the weights only.
//
// Layouts (as the JAX op): rbf, rbfp, rbfd [B,A,A,R]; envf, envp, envfd [B,A,A];
// xin, xind, msg, gmsg [B,A,F]; contiguous.
//
// Two dtypes, as the JAX kernels' modes: every pair and node input (and the cotangents gmsg,
// gmsgd) float32, or every one bfloat16 (the `_bf16` entry points); the filter weights W1, b1,
// W2, b2 are float32 in both (the JAX model's raw params). The bf16 mode reads its inputs as
// bf16 straight from device memory, widens them and computes in fp32 like the TPU kernels
// (which read the inputs' dtype and compute in F32), and rounds once: E and G write msg (and
// msgd) in bf16, F and H write fp32 (their wrappers round gxin, gxind to bf16 as the JAX
// wrappers do; g_dist and gW stay fp32). The rbf rows go onto the engine as bf16 (`abf16`: a
// bf16 value is a TF32 value with lo = 0); W1 is fp32, so z1 = rbf W1 keeps the 3xTF32 passes
// (the a_lo b_hi pass adds zeros) and is as accurate as the fp32 path. h W2, the gradient
// products and the weight gradients read fp32 values the kernels compute, as in fp32.
//
// Every kernel runs its filter-MLP products (~96-98 % of its FLOPs) on so2_common.cuh's engine
// (3xTF32 wgmma, fp32-accurate) over the live pairs only, into compact [live, F] rows; K = R
// or F is a few k tiles, so the launches run persistent. A pair is live when envf, or the
// second envelope lane (envp in F, envfd in G and H), is not zero: a dead pair adds exact
// zeros to every output. (The rbf row cannot tell: it is not masked, and b1, b2 make every
// row's MLP nonzero.) What is left runs on the CUDA cores in a stage that sums in registers in
// a fixed order (no partials, no atomics): the same bits on every run. The work is bound by
// operations: at B=64, A=48, R=100, F=128, E's 55,682 live pairs need ~3.3 GFLOP of products
// against ~0.06 GB of inputs and outputs, at least 0.021 ms on an H100 SXM (the products at the
// 3xTF32 rate, 494.5 / 3 TFLOP/s; 0.050 ms all at the fp32 FMA rate); G twice that (0.042 and
// 0.099 ms).
//
// E and G, whose outputs are sums over senders j for a fixed receiver i (msg; G's msgd), list
// the live pairs in receiver order:
//   * schnet_flags_kernel<false> marks pair row (b, i, j) live when envf (G: or envfd) is not
//     zero; a pair live through envfd alone still adds its wmr envfd xin_j term to msgd.
//     live_rows over segments of A rows (a receiver's) lists the live pair rows with each
//     receiver's first row: the list is the engine's gather list as it stands.
//   * z1 = rbf W1 + b1 (G: and z1d = rbfd W1, a second problem of the same launch) over the
//     gathered rows; schnet_ssp_kernel writes h = ssp(z1) over z1 (G: and hd = s z1d over
//     z1d, s = sigmoid(z1), which is not kept); then wmr = h W2 + b2 (G: and wmrd = hd W2) in
//     one launch. A call's scratch is two [B*A*A, F] arrays for E and four for G.
//   * A stage, one block per (b, receiver i) and a thread per channel, walks i's live senders
//     in list order: it reads each pair's product rows once, the sender's xin (G: and xind)
//     row through L2 and the receiver's envf (G: and envfd) row from shared memory. It writes
//     every receiver's row, zeros where the list is empty (padding, isolated atoms, an
//     all-dead batch), so the outputs need no fill.
//
// F and H, whose outputs are sums over receivers i for a fixed sender j (gxin; H's gxind), a
// sum over channels per pair (F's g_dist) and the weight gradients, sums over every pair, list
// the live pairs in sender order:
//   * schnet_flags_kernel<true> marks slot (b, j, i) live when envf[b,i,j] or the second lane
//     (envp in F, envfd in H) is not zero; live_rows lists the live slots in that sender order
//     with each sender's first row, and so2_pair_rows_kernel maps them to their pair rows (b,
//     i, j).
//   * z1 = rbf W1 + b1 and the second lane a2 W1 (F: rpw = rbfp W1; H: z1d = rbfd W1) over the
//     gathered rows; after schnet_ssp_kernel (s, h and H's hd = s z1d), wmr = h W2 + b2 (H: and
//     wmrd = hd W2).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "so2_common.cuh"

namespace {

constexpr float LOG2F = 0.6931471805599453f;

// the stages' loads and stores of the inputs' dtype T (fp32 arithmetic; a bf16 store rounds
// to nearest even)
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// softplus(x) - log 2 (as jax.nn.softplus: max(x,0) + log1p(exp(-|x|))) and
// sigmoid(x), both from one exp
__device__ inline void ssp_sigmoid(float x, float& h, float& s) {
  const float e = expf(-fabsf(x));
  h = fmaxf(x, 0.f) + log1pf(e) - LOG2F;
  s = (x >= 0.f ? 1.f : e) / (1.f + e);
}

// ---------------------------------------------------------------------------
// the live pairs and the first layer's activation
// ---------------------------------------------------------------------------

// flags = 1 for a pair p = (b*A + i)*A + j whose envf[p] or env2[p] (where given: envp in F,
// envfd in G and H) is not zero: a thread a pair. BY_SENDER (F, H): at slot (b*A + j)*A + i;
// else (E, G) at p, the pair row. (bf16 keeps fp32's exponent range, so a pair live in fp32 is
// live in bf16: its envelope rounds to a nonzero bf16 value.)
template <bool BY_SENDER, typename T>
__global__ void schnet_flags_kernel(const T* __restrict__ env, const T* __restrict__ env2,
                                    int* __restrict__ flags, int A, long long npairs) {
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npairs) return;
  const int live = ldf(env + p) != 0.f || (env2 != nullptr && ldf(env2 + p) != 0.f);
  if (!BY_SENDER) {
    flags[p] = live;
    return;
  }
  const long long bi = p / A, b = bi / A;
  const int j = (int)(p - bi * A), i = (int)(bi - b * A);
  flags[(b * A + j) * A + i] = live;
}

// Over the live rows (n_rows x ld, float4 at a time), from z1 in z: h = ssp(z1) into h (which
// may be z itself: E and G keep no s), s = sigmoid(z1) into s where given (F and H: s is z);
// with zd (G, H), z1d becomes hd = s z1d in place. z, s and h may alias, so none is restrict.
__global__ void __launch_bounds__(256) schnet_ssp_kernel(const float* z, float* s, float* h,
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
    if (s) reinterpret_cast<float4*>(s)[q] = sv;
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
constexpr int EQ = 8;  // E's and G's stages: senders a thread holds at once

// ---------------------------------------------------------------------------
// kernel E's stage: one block per (molecule b, receiver i), over i's live senders j (rows
// rs[bi] .. rs[bi+1] - 1 of the compact wmr = h W2 + b2, F floats a row; eidx[e] the pair row
// (b*A + i)*A + j), EQ at a time. Per channel f, in list order: msg_i = sum_j wmr envf xin_j.
// ---------------------------------------------------------------------------

template <int MAXT, typename T>
__global__ void __launch_bounds__(MAXT) schnet_fwd_stage_kernel(
    const float* __restrict__ wmr, const int* __restrict__ eidx, const int* __restrict__ rs,
    const T* __restrict__ envf, const T* __restrict__ xin, T* __restrict__ msg, int A, int F) {
  extern __shared__ float stage_s[];  // [A]: envf[b,i,j] of this receiver
  const int bi = blockIdx.x, b = bi / A, f = threadIdx.x;
  for (int j = f; j < A; j += blockDim.x) stage_s[j] = ldf(envf + (size_t)bi * A + j);
  __syncthreads();
  if (f >= F) return;
  const int e_lo = rs[bi], e_hi = rs[bi + 1], row0 = bi * A;  // eidx[e] - row0 = sender j
  const T* xb = xin + (size_t)b * A * F + f;
  float m = 0.f;
  for (int e0 = e_lo; e0 < e_hi; e0 += EQ) {
    const int n = min(EQ, e_hi - e0);
    // every load of the EQ senders first, so that their latencies overlap
    float w[EQ], x[EQ];
    int jj[EQ];
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0);
      jj[q] = eidx[e] - row0;
      w[q] = ok ? wmr[(size_t)e * F + f] : 0.f;
      x[q] = ok ? ldf(xb + (size_t)jj[q] * F) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q) m = fmaf(w[q] * stage_s[jj[q]], x[q], m);
  }
  stf(msg + (size_t)bi * F + f, m);
}

// ---------------------------------------------------------------------------
// kernel G's stage: as E's, over i's live senders j (rows of the compact wmr = h W2 + b2 and
// wmrd = hd W2), with the tangent lane. Per channel f, in list order, with e = envf, ed =
// envfd of the pair:
//   wm = wmr e,   wmd = wmrd e + wmr ed,   msg_i = sum_j wm xin_j,
//   msgd_i = sum_j wmd xin_j + wm xind_j
// ---------------------------------------------------------------------------

template <int MAXT, typename T>
__global__ void __launch_bounds__(MAXT) schnet_dual_fwd_stage_kernel(
    const float* __restrict__ wmr, const float* __restrict__ wmrd, const int* __restrict__ eidx,
    const int* __restrict__ rs, const T* __restrict__ envf, const T* __restrict__ envfd,
    const T* __restrict__ xin, const T* __restrict__ xind, T* __restrict__ msg,
    T* __restrict__ msgd, int A, int F) {
  extern __shared__ float stage_s[];
  float* e_s = stage_s;   // [A]: envf[b,i,j] of this receiver
  float* ed_s = e_s + A;  // [A]: envfd[b,i,j]
  const int bi = blockIdx.x, b = bi / A, f = threadIdx.x;
  for (int j = f; j < A; j += blockDim.x) {
    e_s[j] = ldf(envf + (size_t)bi * A + j);
    ed_s[j] = ldf(envfd + (size_t)bi * A + j);
  }
  __syncthreads();
  if (f >= F) return;
  const int e_lo = rs[bi], e_hi = rs[bi + 1], row0 = bi * A;
  const size_t nb = (size_t)b * A * F + f;
  float m0 = 0.f, m1 = 0.f;
  for (int e0 = e_lo; e0 < e_hi; e0 += EQ) {
    const int n = min(EQ, e_hi - e0);
    float w[EQ], wd[EQ], x[EQ], xd[EQ];
    int jj[EQ];
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const bool ok = q < n;
      const int e = e0 + (ok ? q : 0);
      jj[q] = eidx[e] - row0;
      const size_t nj = nb + (size_t)jj[q] * F;
      w[q] = ok ? wmr[(size_t)e * F + f] : 0.f;
      wd[q] = ok ? wmrd[(size_t)e * F + f] : 0.f;
      x[q] = ok ? ldf(xin + nj) : 0.f;
      xd[q] = ok ? ldf(xind + nj) : 0.f;
    }
#pragma unroll
    for (int q = 0; q < EQ; ++q) {
      const int j = jj[q];
      const float wm = w[q] * e_s[j];
      const float wmd = fmaf(wd[q], e_s[j], w[q] * ed_s[j]);
      m0 = fmaf(wm, x[q], m0);
      m1 = fmaf(wmd, x[q], fmaf(wm, xd[q], m1));
    }
  }
  stf(msg + (size_t)bi * F + f, m0);
  stf(msgd + (size_t)bi * F + f, m1);
}

// ---------------------------------------------------------------------------
// kernel F's stage: one block per (molecule b, sender j), over j's live receivers i (rows
// rs[bj] .. rs[bj+1] - 1 of the compact wmr = h W2 + b2, F floats a row), FQ at a time. Per
// pair and channel f, with gwm = gmsg_i xin_j:
//   gxin_j += wmr envf gmsg_i,   g_env = sum_f gwm wmr (into ge[e]),   gwmr = gwm envf
// and gwmr overwrites wmr (each element read and written by one thread).
// ---------------------------------------------------------------------------

template <int MAXT, typename T>
__global__ void __launch_bounds__(MAXT) schnet_bwd_stage_kernel(
    float* __restrict__ w, float* __restrict__ ge, const int* __restrict__ eidx,
    const int* __restrict__ rs, const int* __restrict__ row, const T* __restrict__ envf,
    const T* __restrict__ xin, const T* __restrict__ gmsg, float* __restrict__ gxin, int A,
    int F) {
  extern __shared__ float red[];  // [2][warps][32]: the warps' pair sums, double buffered
  const int bj = blockIdx.x, b = bj / A;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5, f = tid;
  const bool act = f < F;
  const float x = act ? ldf(xin + (size_t)bj * F + f) : 0.f;
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
      ef[q] = ok ? ldf(envf + row[e]) : 0.f;
      wv[q] = ok && act ? w[(size_t)e * F + f] : 0.f;
      gm[q] = ok && act ? ldf(gmsg + ((size_t)b * A + i) * F + f) : 0.f;
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
template <typename T>
__global__ void __launch_bounds__(256) schnet_gdist_kernel(
    const float* __restrict__ gz1, const float* __restrict__ rp, const float* __restrict__ ge,
    const int* __restrict__ row, const int* __restrict__ n_rows, const T* __restrict__ envp,
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
      gdist[p] = fmaf(ge[e], ldf(envp + p), acc);
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

template <int MAXT, typename T>
__global__ void __launch_bounds__(MAXT) schnet_dual_bwd_stage_kernel(
    float* __restrict__ w, float* __restrict__ wd, const int* __restrict__ eidx,
    const int* __restrict__ rs, const int* __restrict__ row, const T* __restrict__ envf,
    const T* __restrict__ envfd, const T* __restrict__ xin, const T* __restrict__ xind,
    const T* __restrict__ gmsg, const T* __restrict__ gmsgd, float* __restrict__ gxin,
    float* __restrict__ gxind, int need_gw, int A, int F) {
  const int bj = blockIdx.x, b = bj / A, f = threadIdx.x;
  if (f >= F) return;
  const size_t nj = (size_t)bj * F + f;
  const float x = ldf(xin + nj), xd = ldf(xind + nj);
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
      ev[q] = ok ? ldf(envf + p) : 0.f;
      edv[q] = ok ? ldf(envfd + p) : 0.f;
      wr[q] = ok ? w[(size_t)e * F + f] : 0.f;
      wdr[q] = ok ? wd[(size_t)e * F + f] : 0.f;
      gm[q] = ok ? ldf(gmsg + node) : 0.f;
      gmd[q] = ok ? ldf(gmsgd + node) : 0.f;
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
// on the host: the live pairs, the filter-MLP products and gW on the engine
// ---------------------------------------------------------------------------

// what a call carves from its scratch: rows x ld arrays (E: z, w; G: z, z2, w, w2; F: z, z2,
// h, w; H: all five)
struct Work {
  float *z, *z2, *h, *w, *w2;  // see the entry points
  float* ge;                   // F: g_env of each live row
  float* cs;                   // F, H: the bias sums' partials [2][CS_CHUNKS][F]
  int *flags, *eidx, *pos, *rs, *n_rows;
  int* row;                    // sender order (F, H): the pair rows of the listed slots
  Engine en;
};

enum { KIND_F = 0, KIND_H = 1, KIND_E = 2, KIND_G = 3 };

long long pair_rows(int B, int A) { return (long long)B * A * A; }
bool by_sender(int kind) { return kind == KIND_F || kind == KIND_H; }
int n_arrays(int kind) {
  constexpr int n[] = {4, 5, 2, 4};
  return n[kind];
}

constexpr bool is_bf16(const float*) { return false; }
constexpr bool is_bf16(const __nv_bfloat16*) { return true; }

// the weight-gradient products of a call (the biases are schnet_colsum_kernel's): F one launch
// (gW1 and gW2 together), H two (gW2, then gW1); pointers null to size the partials. a1, a2
// are the pair tensors (bf16 values where a16).
std::vector<std::vector<TNProb>> wgrad_launches(int kind, const Work& w, const void* a1,
                                                const void* a2, int a16, float* gw, int R,
                                                int F) {
  float* gw2 = gw ? gw + (long long)(R + 1) * F : nullptr;
  const float* p1 = static_cast<const float*>(a1);
  const float* p2 = static_cast<const float*>(a2);
  if (kind == KIND_F) {
    return {{tprob({TSeg{p1, w.z, R, F, 1.f, a16}}, A_GATHER, R, F, gw, F),
             tprob({TSeg{w.h, w.w, F, F, 1.f}}, A_ROWS, F, F, gw2, F)}};
  }
  return {{tprob({TSeg{w.h, w.w, F, F, 1.f}, TSeg{w.z2, w.w2, F, F, 1.f}}, A_ROWS, F, F, gw2, F)},
          {tprob({TSeg{p1, w.h, R, F, 1.f, a16}, TSeg{p2, w.w, R, F, 1.f, a16}}, A_GATHER, R, F,
                 gw, F)}};
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
  for (const auto& probs : wgrad_launches(kind, Work{}, nullptr, nullptr, 0, nullptr, R, F))
    need = std::max(need, wgrad_part_floats(rows, probs));
  return need;
}

long long prep_floats(int R, int F) { return 2LL * F * std::max(R, F); }

// the arrays, the weights' TF32 halves and, in F and H, gW's and the bias sums' partials (and
// F's g_env)
long long scratch_floats(int kind, int B, int A, int R, int F) {
  const long long rows = pair_rows(B, A);
  const long long base = n_arrays(kind) * rows * F + prep_floats(R, F);
  if (!by_sender(kind)) return base;
  return base + part_floats(kind, rows, R, F) + 2LL * CS_CHUNKS * F + (kind == KIND_F ? rows : 0);
}

// the flags, the list, its positions, each segment's first row and the count; in sender order
// the pair rows too
long long scratch_ints(int B, int A, bool sender_order) {
  return (sender_order ? 4 : 3) * pair_rows(B, A) + (long long)B * A + 2;
}

Work carve_work(int kind, int B, int A, int R, int F, float* f, int* iw) {
  const long long rows = pair_rows(B, A), arr = rows * F;
  const bool sender_order = by_sender(kind);
  Work w{};
  float** slot[5] = {&w.z, &w.z2, &w.h, &w.w, &w.w2};  // F, H; E: z, w; G: z, z2, w, w2
  if (kind == KIND_E) slot[1] = &w.w;
  if (kind == KIND_G) slot[2] = &w.w, slot[3] = &w.w2;
  for (int q = 0; q < n_arrays(kind); ++q) *slot[q] = f + q * arr;
  float* prep = f + n_arrays(kind) * arr;
  float* part = prep + prep_floats(R, F);
  const long long part_n = sender_order ? part_floats(kind, rows, R, F) : 0;
  if (sender_order) {
    w.cs = part + part_n;
    w.ge = kind == KIND_F ? w.cs + 2LL * CS_CHUNKS * F : nullptr;
  }
  w.flags = iw;
  w.eidx = iw + rows;
  w.pos = iw + 2 * rows;
  int* q = iw + 3 * rows;
  if (sender_order) {
    w.row = q;
    q += rows;
  }
  w.rs = q;
  w.n_rows = q + (long long)B * A + 1;
  // the engine gathers pair rows (b, i, j): in receiver order the list's own entries, in
  // sender order those of the listed slots
  w.en = Engine{rows, w.n_rows, sender_order ? w.row : w.eidx, prep, prep_floats(R, F),
                sender_order ? part : nullptr, part_n};
  return w;
}

// the live pairs (envf or env2 not zero), in receiver order (the engine's live_rows over
// segments of A pair rows) or in sender order (slots (b, j, i), then their pair rows), with
// each segment's first row
template <typename T>
cudaError_t live_pairs(const Work& w, const T* envf, const T* env2, int B, int A,
                       bool sender_order, cudaStream_t st) {
  const long long rows = pair_rows(B, A);
  const unsigned blocks = (unsigned)((rows + 255) / 256);
  const auto mark = sender_order ? schnet_flags_kernel<true, T> : schnet_flags_kernel<false, T>;
  mark<<<blocks, 256, 0, st>>>(envf, env2, w.flags, A, rows);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = live_rows(w.flags, w.eidx, w.pos, w.rs, w.n_rows, rows, A, st);
  if (err != cudaSuccess || !sender_order) return err;
  so2_pair_rows_kernel<<<blocks, 256, 0, st>>>(w.eidx, w.n_rows, w.row, A);
  return cudaGetLastError();
}

// blocks of 256 threads for `elems` threads' work, at most 8 an SM (the loops stride)
unsigned row_blocks(long long elems) {
  return (unsigned)std::max(1LL, std::min((elems + 255) / 256, 8LL * SMS));
}

// an engine segment over the gathered pair rows a (fp32, or bf16 read as such: `abf16`; W1 is
// fp32, so not `one`: the 3xTF32 passes stay)
template <typename T>
Seg pair_seg(const T* a, const float* w1, int R, int F) {
  Seg s = seg(reinterpret_cast<const float*>(a), R, w1, F, R);
  s.abf16 = is_bf16(a);
  return s;
}

// z1 = a1 W1 + b1 into z (and a2 W1 into z2 where a2 is given: F's rpw = rbfp W1, G's and H's
// z1d = rbfd W1) over the gathered live rows; then schnet_ssp_kernel: h = ssp(z1) into h,
// s = sigmoid(z1) into s where given and, with `dual`, hd = s z1d over z2
template <typename T>
cudaError_t first_layer(const Work& w, const T* a1, const T* a2, const float* w1,
                        const float* b1, float* s, float* h, bool dual, int R, int F,
                        cudaStream_t st) {
  std::vector<NNProb> probs{prob({pair_seg(a1, w1, R, F)}, F, EPI_GATES, w.z, F)};
  probs[0].bias = b1;
  if (a2) probs.push_back(prob({pair_seg(a2, w1, R, F)}, F, EPI_STORE, w.z2, F));
  for (NNProb& p : probs) p.gather = 1;
  cudaError_t err = launch_products(w.en, probs, st, true);
  if (err != cudaSuccess) return err;
  schnet_ssp_kernel<<<row_blocks(w.en.max_rows * F / 4), 256, 0, st>>>(
      w.z, s, h, dual ? w.z2 : nullptr, w.n_rows, F);
  return cudaGetLastError();
}

// wmr = h W2 + b2 into w (and wmrd = hd W2 into w2 where hd is given) over the compact rows
cudaError_t second_layer(const Work& w, const float* h, const float* hd, const float* w2,
                         const float* b2, int F, cudaStream_t st) {
  std::vector<NNProb> probs{prob({seg(h, F, w2, F, F)}, F, EPI_GATES, w.w, F)};
  probs[0].bias = b2;
  if (hd) probs.push_back(prob({seg(hd, F, w2, F, F)}, F, EPI_STORE, w.w2, F));
  return launch_products(w.en, probs, st, true);
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

// E's stage: the receiver's envf row; G's: its envf and envfd rows
size_t fwd_stage_smem(int A, int lanes) { return sizeof(float) * lanes * (size_t)A; }

// the pair tensors' rows are read in chunks of four values (16 bytes of fp32, 8 of bf16)
template <typename T>
bool pairs_aligned(const T* p) { return is_bf16(p) ? aligned8(p) : aligned16(p); }

// ---------------------------------------------------------------------------
// the four kernels, for inputs of dtype T (float, or __nv_bfloat16: the bf16 mode)
// ---------------------------------------------------------------------------

template <typename T>
int fwd(const T* rbf, const T* envf, const T* xin, const float* w1, const float* b1,
        const float* w2, const float* b2, T* msg, float* scratch, int* iscratch, int B, int A,
        int R, int F, void* stream) {
  if (!shapes_ok(B, A, R, F) || !pairs_aligned(rbf)) return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve_work(KIND_E, B, A, R, F, scratch, iscratch);
  cudaError_t err = live_pairs(wk, envf, (const T*)nullptr, B, A, false, st);
  // h over z1, then wmr
  if (err == cudaSuccess)
    err = first_layer(wk, rbf, (const T*)nullptr, w1, b1, nullptr, wk.z, false, R, F, st);
  if (err == cudaSuccess) err = second_layer(wk, wk.z, nullptr, w2, b2, F, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_stage_smem(A, 1);
  return (int)run_stage(schnet_fwd_stage_kernel<SMAXT, T>, schnet_fwd_stage_kernel<1024, T>, F,
                        smem, [&](auto kernel, int threads) {
                          kernel<<<B * A, threads, smem, st>>>(wk.w, wk.eidx, wk.rs, envf, xin,
                                                               msg, A, F);
                          return cudaGetLastError();
                        });
}

template <typename T>
int bwd(const T* rbf, const T* rbfp, const T* envf, const T* envp, const T* xin,
        const float* w1, const float* b1, const float* w2, const float* b2, const T* gmsg,
        float* gdist, float* gxin, float* gw, float* scratch, int* iscratch, int need_gw, int B,
        int A, int R, int F, void* stream) {
  if (!shapes_ok(B, A, R, F) || !pairs_aligned(rbf) || !pairs_aligned(rbfp))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve_work(KIND_F, B, A, R, F, scratch, iscratch);
  cudaError_t err = live_pairs(wk, envf, envp, B, A, true, st);
  if (err == cudaSuccess) err = first_layer(wk, rbf, rbfp, w1, b1, wk.z, wk.h, false, R, F, st);
  if (err == cudaSuccess) err = second_layer(wk, wk.h, nullptr, w2, b2, F, st);
  if (err == cudaSuccess) {
    const size_t smem = bwd_stage_smem(F);
    err = run_stage(schnet_bwd_stage_kernel<SMAXT, T>, schnet_bwd_stage_kernel<1024, T>, F, smem,
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
    schnet_gdist_kernel<T><<<row_blocks(pair_rows(B, A) * 32), 256, 0, st>>>(
        wk.z, wk.z2, wk.ge, wk.row, wk.n_rows, envp, gdist, F);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || !need_gw) return (int)err;
  err = launch_wgrads(wk.en, wgrad_launches(KIND_F, wk, rbf, nullptr, is_bf16(rbf), gw, R, F)[0],
                      st);
  return (int)(err != cudaSuccess ? err : bias_sums(wk, wk.z, wk.w, gw, R, F, st));
}

template <typename T>
int dual_fwd(const T* rbf, const T* rbfd, const T* envf, const T* envfd, const T* xin,
             const T* xind, const float* w1, const float* b1, const float* w2, const float* b2,
             T* msg, T* msgd, float* scratch, int* iscratch, int B, int A, int R, int F,
             void* stream) {
  if (!shapes_ok(B, A, R, F) || !pairs_aligned(rbf) || !pairs_aligned(rbfd))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve_work(KIND_G, B, A, R, F, scratch, iscratch);
  cudaError_t err = live_pairs(wk, envf, envfd, B, A, false, st);
  // h over z1 and hd over z1d, then wmr and wmrd
  if (err == cudaSuccess) err = first_layer(wk, rbf, rbfd, w1, b1, nullptr, wk.z, true, R, F, st);
  if (err == cudaSuccess) err = second_layer(wk, wk.z, wk.z2, w2, b2, F, st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = fwd_stage_smem(A, 2);
  return (int)run_stage(schnet_dual_fwd_stage_kernel<SMAXT, T>,
                        schnet_dual_fwd_stage_kernel<1024, T>, F, smem,
                        [&](auto kernel, int threads) {
                          kernel<<<B * A, threads, smem, st>>>(wk.w, wk.w2, wk.eidx, wk.rs, envf,
                                                               envfd, xin, xind, msg, msgd, A, F);
                          return cudaGetLastError();
                        });
}

template <typename T>
int dual_bwd(const T* rbf, const T* rbfd, const T* envf, const T* envfd, const T* xin,
             const T* xind, const float* w1, const float* b1, const float* w2, const float* b2,
             const T* gmsg, const T* gmsgd, float* gxin, float* gxind, float* gw, float* scratch,
             int* iscratch, int need_gw, int B, int A, int R, int F, void* stream) {
  if (!shapes_ok(B, A, R, F) || !pairs_aligned(rbf) || !pairs_aligned(rbfd))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || A == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Work wk = carve_work(KIND_H, B, A, R, F, scratch, iscratch);
  cudaError_t err = live_pairs(wk, envf, envfd, B, A, true, st);
  if (err == cudaSuccess) err = first_layer(wk, rbf, rbfd, w1, b1, wk.z, wk.h, true, R, F, st);
  if (err == cudaSuccess) err = second_layer(wk, wk.h, wk.z2, w2, b2, F, st);
  if (err == cudaSuccess) {
    err = run_stage(schnet_dual_bwd_stage_kernel<SMAXT, T>, schnet_dual_bwd_stage_kernel<1024, T>,
                    F, 0, [&](auto kernel, int threads) {
                      kernel<<<B * A, threads, 0, st>>>(wk.w, wk.w2, wk.eidx, wk.rs, wk.row,
                                                        envf, envfd, xin, xind, gmsg, gmsgd,
                                                        gxin, gxind, need_gw, A, F);
                      return cudaGetLastError();
                    });
  }
  if (err != cudaSuccess || !need_gw) return (int)err;
  const auto launches = wgrad_launches(KIND_H, wk, rbf, rbfd, is_bf16(rbf), gw, R, F);
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

}  // namespace

extern "C" {

// Dynamic shared memory per block of kernel `which` (0 E's stage, 1 F's stage, 2 G's stage, 3
// H's stage) at these sizes, as the launches ask for it; -1 for an unknown kernel.
int schnet_smem_bytes(int which, int A, int R, int F) {
  (void)R;
  switch (which) {
    case 0: return (int)fwd_stage_smem(A, 1);
    case 1: return (int)bwd_stage_smem(F);
    case 2: return (int)fwd_stage_smem(A, 2);
    case 3: return 0;
    default: return -1;
  }
}

// Every entry point returns a cudaError_t (0 = success), launches on `stream` and does not
// sync. They take R and F multiples of 4, F <= 1024 and 16-byte aligned pair tensors (8-byte
// in bf16; else cudaErrorInvalidValue), which the wrapper provides by zero padding, and scratch
// and iscratch as the *_scratch_floats / _ints functions size them.

// float and int scratch of a call of kernel `which` (0 E: schnet_fwd, 1 G: schnet_dual_fwd) on
// B molecules of A atoms with R radial values and F channels
long long schnet_fwd_scratch_floats(int which, int B, int A, int R, int F) {
  return scratch_floats(which ? KIND_G : KIND_E, B, A, R, F);
}

long long schnet_fwd_scratch_ints(int B, int A) { return scratch_ints(B, A, false); }

// Kernel E: every row of msg [B,A,F] is written.
int schnet_fwd(const float* rbf, const float* envf, const float* xin, const float* w1,
               const float* b1, const float* w2, const float* b2, float* msg, float* scratch,
               int* iscratch, int B, int A, int R, int F, void* stream) {
  return fwd(rbf, envf, xin, w1, b1, w2, b2, msg, scratch, iscratch, B, A, R, F, stream);
}

// float and int scratch of a call of kernel `which` (0 F: schnet_bwd, 1 H: schnet_dual_bwd)
long long schnet_bwd_scratch_floats(int which, int B, int A, int R, int F) {
  return scratch_floats(which, B, A, R, F);
}

long long schnet_bwd_scratch_ints(int B, int A) { return scratch_ints(B, A, true); }

// Kernels F and H: gw [R + 1 + F + 1, F] (gW1, gb1, gW2, gb2) is written only when need_gw != 0.
// Kernel F: gdist [B,A,A] must hold zeros (only live pairs are written).
int schnet_bwd(const float* rbf, const float* rbfp, const float* envf, const float* envp,
               const float* xin, const float* w1, const float* b1, const float* w2,
               const float* b2, const float* gmsg, float* gdist, float* gxin, float* gw,
               float* scratch, int* iscratch, int need_gw, int B, int A, int R, int F,
               void* stream) {
  return bwd(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg, gdist, gxin, gw, scratch,
             iscratch, need_gw, B, A, R, F, stream);
}

// Kernel G: as E (its live pairs are those of envf or envfd); every row of msg and msgd is
// written.
int schnet_dual_fwd(const float* rbf, const float* rbfd, const float* envf, const float* envfd,
                    const float* xin, const float* xind, const float* w1, const float* b1,
                    const float* w2, const float* b2, float* msg, float* msgd, float* scratch,
                    int* iscratch, int B, int A, int R, int F, void* stream) {
  return dual_fwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, msg, msgd, scratch,
                  iscratch, B, A, R, F, stream);
}

// Kernel H: as F (its live pairs are those of envf or envfd).
int schnet_dual_bwd(const float* rbf, const float* rbfd, const float* envf, const float* envfd,
                    const float* xin, const float* xind, const float* w1, const float* b1,
                    const float* w2, const float* b2, const float* gmsg, const float* gmsgd,
                    float* gxin, float* gxind, float* gw, float* scratch, int* iscratch,
                    int need_gw, int B, int A, int R, int F, void* stream) {
  return dual_bwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, gmsg, gmsgd, gxin, gxind,
                  gw, scratch, iscratch, need_gw, B, A, R, F, stream);
}

// The bf16 mode of E-H: the same entry points with every pair and node input (and cotangent)
// bf16, 8-byte aligned pair tensors, fp32 weights, the same scratch; E and G write bf16, F and
// H fp32.
typedef __nv_bfloat16 bf16;

int schnet_fwd_bf16(const bf16* rbf, const bf16* envf, const bf16* xin, const float* w1,
                    const float* b1, const float* w2, const float* b2, bf16* msg, float* scratch,
                    int* iscratch, int B, int A, int R, int F, void* stream) {
  return fwd(rbf, envf, xin, w1, b1, w2, b2, msg, scratch, iscratch, B, A, R, F, stream);
}

int schnet_bwd_bf16(const bf16* rbf, const bf16* rbfp, const bf16* envf, const bf16* envp,
                    const bf16* xin, const float* w1, const float* b1, const float* w2,
                    const float* b2, const bf16* gmsg, float* gdist, float* gxin, float* gw,
                    float* scratch, int* iscratch, int need_gw, int B, int A, int R, int F,
                    void* stream) {
  return bwd(rbf, rbfp, envf, envp, xin, w1, b1, w2, b2, gmsg, gdist, gxin, gw, scratch,
             iscratch, need_gw, B, A, R, F, stream);
}

int schnet_dual_fwd_bf16(const bf16* rbf, const bf16* rbfd, const bf16* envf, const bf16* envfd,
                         const bf16* xin, const bf16* xind, const float* w1, const float* b1,
                         const float* w2, const float* b2, bf16* msg, bf16* msgd, float* scratch,
                         int* iscratch, int B, int A, int R, int F, void* stream) {
  return dual_fwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, msg, msgd, scratch,
                  iscratch, B, A, R, F, stream);
}

int schnet_dual_bwd_bf16(const bf16* rbf, const bf16* rbfd, const bf16* envf, const bf16* envfd,
                         const bf16* xin, const bf16* xind, const float* w1, const float* b1,
                         const float* w2, const float* b2, const bf16* gmsg, const bf16* gmsgd,
                         float* gxin, float* gxind, float* gw, float* scratch, int* iscratch,
                         int need_gw, int B, int A, int R, int F, void* stream) {
  return dual_bwd(rbf, rbfd, envf, envfd, xin, xind, w1, b1, w2, b2, gmsg, gmsgd, gxin, gxind,
                  gw, scratch, iscratch, need_gw, B, A, R, F, stream);
}

}  // extern "C"
