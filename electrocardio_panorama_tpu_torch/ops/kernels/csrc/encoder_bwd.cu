// Fused Nef-Net encoder, backward (kernel A3) for Hopper, sm_90a.
//
// Replaces the TPU kernel electrocardio_panorama_tpu/ops/pallas/encoder_fused.py
// ::_bwd_kernel (via _bwd_call), the backward of encode_fused_train: recompute
// the forward planes that were not checkpointed (level 2: all of them,
// `encoder_ckpt='off'`; level 1: the post-tower planes, 'tower'; level 0:
// none, 'full'), then walk the chain in reverse, emitting the gate gradient
// and every weight and bias gradient summed over the batch. x, the dropout
// masks and the ROI ramp get none.
//
// Gradients are float. As in the TPU kernel, a gradient rounds to the
// storage type only where it is a product's operand; bias sums, residual
// adds and mask products use it unrounded. Relu masks keep where the
// forward output is > 0, and maxpool routes to the first maximal window slot.
//
// Weight gradients are sums over (sample, time): each is a GEMM whose
// reduction is split into a fixed number of position ranges, each block
// writing its partial sum, and a second kernel adds the partials in order.
// No atomics, so every run gives the same bits, whatever the checkpoint
// mode. Every weight gradient but conv1's runs on the engine of its storage
// type (encoder_tc.cuh in bf16, encoder_fma.cuh in float32), conv1's on the
// SIMT dw_kernel. Data gradients go through the forward's conv engines with
// transposed, flipped weights (encoder_common.cuh).

#include <algorithm>

#include "encoder_common.cuh"
#include "stage_timer.cuh"

namespace enc {
namespace {

constexpr int DW_P = 32;         // positions staged per step in the weight-gradient GEMM
constexpr int MAX_SPLIT = 8;     // position ranges the workspace holds for the largest weight gradient
constexpr int TARGET_BLOCKS = 264;
constexpr int TC_TARGET_BLOCKS = 132;
constexpr int FMA_TARGET_BLOCKS = 528;  // four 64-thread blocks per SM
constexpr int MAX_RANGES = 64;

// out[i] = a[i] where g[i] > 0, else 0.
template <typename S, typename TA>
__global__ void gt_kernel(const TA* __restrict__ a, const S* __restrict__ g, float* __restrict__ out,
                          long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  out[e] = ld(g + e) > 0.f ? ld(a + e) : 0.f;
}

// The gate: da2 = dhg * gate[row] where h3 > 0 (rows of length T).
template <typename S>
__global__ void gate_bwd_kernel(const float* __restrict__ dhg, const S* __restrict__ gate,
                                const S* __restrict__ h3, float* __restrict__ out, long long n, int T) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  out[e] = ld(h3 + e) > 0.f ? dhg[e] * ld(gate + e / T) : 0.f;
}

// Fixed-order tree sum of the block's 256 partials in shared memory.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// out[row] = sum_t a[row, t] * b[row, t]: the gate gradient (one block per row).
template <typename S>
__global__ void rowdot_kernel(const float* __restrict__ a, const S* __restrict__ b,
                              float* __restrict__ out, int T) {
  __shared__ float red[256];
  const long long row = blockIdx.x;
  float v = 0.f;
  for (int t = threadIdx.x; t < T; t += blockDim.x) v += a[row * T + t] * ld(b + row * T + t);
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[row] = s;
}

// out[c] = sum over (n, t) of a[n, c, t]: a bias gradient (one block per channel).
__global__ void colsum_kernel(const float* __restrict__ a, float* __restrict__ out, int N, int C, int T) {
  __shared__ float red[256];
  const int c = blockIdx.x;
  float v = 0.f;
  for (int e = threadIdx.x; e < N * T; e += blockDim.x) {
    const int n = e / T, t = e - n * T;
    v += a[((long long)n * C + c) * T + t];
  }
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[c] = s;
}

// roi_align backward, with the z2_conv1 output's relu mask:
// dmid[n, c] = sum_u round_s(sum_s dA[n, c*7+s, u] * ramp[n, s, u]);
// out[n, c, t] = 0.5 * round_s(dmid) at t = 63, 64 where z2f > 0, else 0.
template <typename S>
__global__ void roi_bwd_kernel(const float* __restrict__ dA, const S* __restrict__ ramp,
                               const S* __restrict__ z2f, float* __restrict__ out, int N, int C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)N * C * FEAT) return;
  const int t = (int)(e % FEAT);
  const long long nc = e / FEAT;
  float v = 0.f;
  if (t == FEAT / 2 - 1 || t == FEAT / 2) {
    const int n = (int)(nc / C);
    const float* d = dA + nc * SEGS * ALIGN;
    const S* r = ramp + (long long)n * SEGS * ALIGN;
    float dmid = 0.f;
    for (int u = 0; u < ALIGN; ++u) {
      float s = 0.f;
      for (int q = 0; q < SEGS; ++q) s += d[q * ALIGN + u] * ld(r + q * ALIGN + u);
      dmid += round_s<S>(s);
    }
    v = ld(z2f + e) > 0.f ? 0.5f * round_s<S>(dmid) : 0.f;
  }
  out[e] = v;
}

// maxpool(k3, s2, p1) backward into the conv1 output c [N, C, 256], with the
// conv1 relu mask. Window t covers c[2t-1], c[2t], c[2t+1]; the gradient goes
// to the first slot equal to the pooled value.
template <typename S>
__global__ void maxpool_bwd_kernel(const float* __restrict__ dpool, const S* __restrict__ c,
                                   const S* __restrict__ pooled, float* __restrict__ dc, long long rows) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * 2 * FEAT) return;
  const long long row = e / (2 * FEAT);
  const int j = (int)(e - row * 2 * FEAT);
  const S* cr = c + row * 2 * FEAT;
  const S* pr = pooled + row * FEAT;
  const float* dp = dpool + row * FEAT;
  // slot of window t that takes the gradient: 0, 1 or 2
  auto slot = [&](int t) {
    const float m = ld(pr + t);
    if (t > 0 && ld(cr + 2 * t - 1) == m) return 0;
    if (ld(cr + 2 * t) == m) return 1;
    return ld(cr + 2 * t + 1) == m ? 2 : 3;
  };
  float v;
  if ((j & 1) == 0) {
    const int t = j / 2;
    v = slot(t) == 1 ? dp[t] : 0.f;
  } else {
    const int t = (j - 1) / 2;
    v = slot(t) == 2 ? dp[t] : 0.f;
    if (t + 1 < FEAT && slot(t + 1) == 0) v = v + dp[t + 1];
  }
  dc[e] = ld(cr + j) > 0.f ? v : 0.f;
}

// Weight-gradient GEMM: for output channel o of group g and row r = (i, k),
// part[z][g*cog + o][r] = sum over positions p = n*Tout + t in range z of
//   round_s(dy[n, g*cog + o, t*dy_ts + dy_to]) * round_s(x[n, g*x_gs + x_off + i, t*stride + k - pad]).
template <typename S>
struct DwArgs {
  const float* dy;
  int dyC, dyT, dy_ts, dy_to;
  const S* x;
  int xC, xT, x_gs, x_off;
  int cig, K, stride, pad;
  int N, Tout, cog;
  float* part;
  int per;                   // positions per range
};

// grid: (ceil(cig*K / TC), G*cog / TC, ranges)
template <typename S>
__global__ void __launch_bounds__(THREADS) dw_kernel(DwArgs<S> a) {
  __shared__ float dys[DW_P][TC];
  __shared__ float xs[DW_P][TC];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * TC;
  const int oc0 = blockIdx.y * TC;
  const int g = oc0 / a.cog, o0 = oc0 - g * a.cog;
  const int R = a.cig * a.K;
  const int P = a.N * a.Tout;
  const int lo = blockIdx.z * a.per, hi = min(P, lo + a.per);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int q0 = lo; q0 < hi; q0 += DW_P) {
    __syncthreads();
    for (int e = tid; e < DW_P * TC; e += THREADS) {
      const int pp = e % DW_P, cc = e / DW_P;
      const int p = q0 + pp;
      float dv = 0.f, xv = 0.f;
      if (p < hi) {
        const int n = p / a.Tout, t = p - n * a.Tout;
        dv = round_s<S>(a.dy[((long long)n * a.dyC + g * a.cog + o0 + cc) * a.dyT + t * a.dy_ts + a.dy_to]);
        const int r = r0 + cc;
        if (r < R) {
          const int i = r / a.K, k = r - i * a.K;
          const int ti = t * a.stride + k - a.pad;
          if (ti >= 0 && ti < a.xT)
            xv = round_s<S>(ld(a.x + ((long long)n * a.xC + g * a.x_gs + a.x_off + i) * a.xT + ti));
        }
      }
      dys[pp][cc] = dv;
      xs[pp][cc] = xv;
    }
    __syncthreads();
#pragma unroll 4
    for (int pp = 0; pp < DW_P; ++pp) {
      float dv[4], xv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dv[j] = dys[pp][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[pp][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(dv[j], xv[i], acc[j][i]);
    }
  }
  float* part = a.part + (long long)blockIdx.z * (gridDim.y * TC) * R;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oc = oc0 + ty + 16 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + tx + 16 * i;
      if (r < R) part[(long long)oc * R + r] = acc[j][i];
    }
  }
}

// Adds the ranges' partials in order and writes the gradient in the weight's
// layout: (g, o, i, k) at out[g*wsG + o*wsO + i*wsI + k*wsK].
__global__ void dw_reduce_kernel(const float* __restrict__ part, int ranges, long long n, int cog, int cig,
                                 int K, float* __restrict__ out, long long wsG, long long wsO,
                                 long long wsI, long long wsK) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < ranges; ++z) s += part[z * n + e];
  const int R = cig * K;
  const long long oc = e / R;
  const int r = (int)(e - oc * R);
  const long long g = oc / cog;
  const int o = (int)(oc - g * cog);
  const int i = r / K, k = r - i * K;
  out[g * wsG + o * wsO + i * wsI + k * wsK] = s;
}

template <typename S>
struct Workspace {
  float* part;
  long long part_floats;
  Pack<S> pack;  // the engine's packed weights
};

template <typename S>
int weight_grad(const float* dy, int dyC, int dyT, int dy_ts, int dy_to, const void* x, int xC, int xT,
                int x_gs, int x_off, int cig, int K, int stride, int pad, int N, int Tout, int cog, int G,
                void* out, long long wsG, long long wsO, long long wsI, long long wsK, const Workspace<S>& w,
                cudaStream_t st) {
  DwArgs<S> a;
  a.dy = dy; a.dyC = dyC; a.dyT = dyT; a.dy_ts = dy_ts; a.dy_to = dy_to;
  a.x = static_cast<const S*>(x); a.xC = xC; a.xT = xT; a.x_gs = x_gs; a.x_off = x_off;
  a.cig = cig; a.K = K; a.stride = stride; a.pad = pad;
  a.N = N; a.Tout = Tout; a.cog = cog;
  a.part = w.part;
  // the gradients of every conv but conv1 run on the engine of their type,
  // whose position ranges are whole chunks of tc::BP (bf16) or fma::DP (f32)
  const bool bf16 = std::is_same<S, __nv_bfloat16>::value;
  const bool on_tc = bf16 && tc::dw_ok(cig, cog, K, stride, Tout);
  const bool on_fma = !bf16 && fma::dw_ok(cig, cog, K, stride, pad, Tout);
  const int step = on_tc ? tc::BP : on_fma ? fma::DP : DW_P;
  const int R = cig * K, P = N * Tout;
  // blocks per range: an engine's block takes every tap of its tile
  const int tiles = on_tc ? cig / tc::BN * (G * cog / TC)
                          : on_fma ? fma::dw_tiles(cig, cog, K, G) : blocks_for(R, TC) * (G * cog / TC);
  // a tensor-core block fills an SM (one wave of blocks on the H100's 132),
  // four FMA blocks share one. A gradient splits into as many ranges as
  // its partials fit the workspace, up to MAX_RANGES (conv1's, with 6
  // tiles, into 43)
  const long long n = (long long)G * cog * R;
  const long long cap = std::min<long long>(MAX_RANGES, w.part_floats / n);
  int ranges = blocks_for(on_tc ? TC_TARGET_BLOCKS : on_fma ? FMA_TARGET_BLOCKS : TARGET_BLOCKS, tiles);
  ranges = ranges < cap ? ranges : (int)cap;
  const int max_ranges = blocks_for(P, step);
  ranges = ranges < max_ranges ? ranges : max_ranges;
  a.per = blocks_for(blocks_for(P, ranges), step) * step;
  ranges = blocks_for(P, a.per);
  if (ranges * n > w.part_floats) ENC_TRY(cudaErrorInvalidValue);
  if (on_tc) {
    const tc::DwArgs t{dy, dyC, dyT, dy_ts, dy_to, static_cast<const __nv_bfloat16*>(x), xC, xT, x_gs, x_off,
                       cig, K, pad, N, Tout, cog, w.part, a.per};
    ENC_TRY(tc::launch_dw_tc(t, G, ranges, st));
  } else if (on_fma) {
    const fma::DwArgs f{dy, dyC, dyT, dy_ts, dy_to, static_cast<const float*>(x), xC, xT, x_gs, x_off,
                        cig, K, N, Tout, cog, w.part, a.per};
    ENC_TRY(fma::launch_dw_fma(f, G, ranges, st));
  } else {
    auto kern = &dw_kernel<S>;
    ENC_LAUNCH(kern, dim3(blocks_for(R, TC), G * cog / TC, ranges), dim3(THREADS), st, a);
    ENC_TRY(cudaGetLastError());
  }
  auto red = &dw_reduce_kernel;
  ENC_LAUNCH(red, dim3(blocks_for(n, 256)), dim3(256), st, static_cast<const float*>(w.part), ranges, n, cog,
             cig, K, static_cast<float*>(out), wsG, wsO, wsI, wsK);
  ENC_TRY(cudaGetLastError());
  return 0;
}

// Gradient of a torch conv weight [G*cog, cig, K] from dy [N, G*cog, Tout]
// and its input x (channel map g*x_gs + x_off + i).
template <typename S>
int wgrad(const float* dy, const void* x, int xC, int xT, int x_gs, int x_off, int cog, int cig, int K,
          int stride, int pad, int N, int Tout, int G, void* out, const Workspace<S>& w, cudaStream_t st) {
  return weight_grad<S>(dy, G * cog, Tout, 1, 0, x, xC, xT, x_gs, x_off, cig, K, stride, pad, N, Tout, cog,
                        G, out, (long long)cog * cig * K, (long long)cig * K, K, 1, w, st);
}

// The data gradient of a stride-1 conv with torch weight w [G*cog, cig, K]
// as a conv over dy [N, G*cog, T]: output channel i of group g, rows
// (o, k') with weight w[g*cog + o, i, K-1-k'].
template <typename S>
Operand<S, float> dx_operand(const float* dy, int dyC, int dyT, const void* w, int cog, int cig, int K,
                             int pad) {
  return operand<S, float>(dy, dyC, dyT, cog, 0, static_cast<const S*>(w) + (K - 1),
                           (long long)cog * cig * K, K, (long long)cig * K, -1, cog, K, 1, K - 1 - pad);
}

template <typename S>
int colsum(const float* a, int N, int C, int T, void* out, cudaStream_t st) {
  auto kern = &colsum_kernel;
  ENC_LAUNCH(kern, dim3(C), dim3(256), st, a, static_cast<float*>(out), N, C, T);
  ENC_TRY(cudaGetLastError());
  return 0;
}

#define ENC_RC(expr)                   \
  do {                                 \
    int _rc = (expr);                  \
    if (_rc != 0) return _rc;          \
  } while (0)

struct Sizes {
  long long plane, zplane16, zplane32, hplane32, cplane, part;
};

Sizes sizes(int B, int L) {
  Sizes s;
  const long long C = FEAT * L, Cz = FEAT * SEGS * L, Ch = 64 * SEGS * L;
  s.plane = B * C * FEAT;
  s.zplane16 = B * Cz * ALIGN;
  s.zplane32 = B * Cz * 2 * ALIGN;
  s.hplane32 = B * Ch * 2 * ALIGN;
  s.cplane = B * C * 2 * FEAT;
  // the largest weight-gradient GEMM is z2_conv2's [Cz, 128, 3]
  const long long big = Cz * FEAT * 3 > C * FEAT * 7 ? Cz * FEAT * 3 : C * FEAT * 7;
  s.part = MAX_SPLIT * big;
  return s;
}

template <typename S>
long long workspace_floats(int B, int L) {
  const Sizes s = sizes(B, L);
  // + the engine's two packed-weight buffers
  return 2 * s.zplane32 + s.hplane32 + 3 * s.zplane16 + 8 * s.plane + s.cplane + s.part + pack_floats<S>(L);
}

// The chain's sections, in order, for the optional timer (SECTIONS in
// ops/kernels/encoder_fused.py): recompute, z2_conv2, roi + z-blocks,
// w_conv + gate, tower, maxpool + conv1.
template <typename S>
int backward(void* const* P, int B, int L, int level, float* wsp, float* section_ms, cudaStream_t st) {
  timing::StageTimer timer(section_ms, st);
  const Sizes sz = sizes(B, L);
  float* packed = wsp + workspace_floats<S>(B, L) - pack_floats<S>(L);
  ENC_RC(forward_chain<S>(P, B, L, level, 1, st, packed));
  timer.mark();
  const int C = FEAT * L, G7 = SEGS * L, Cz = FEAT * G7, Ch = 64 * G7;
  const int T = FEAT, T16 = ALIGN, T32 = 2 * ALIGN;
  float* da32 = wsp;
  float* da1_32 = da32 + sz.zplane32;
  float* dHt = da1_32 + sz.zplane32;
  float* da16 = dHt + sz.hplane32;
  float* da1_16 = da16 + sz.zplane16;
  float* dA = da1_16 + sz.zplane16;
  float* daz1 = dA + sz.zplane16;
  float* daz2 = daz1 + sz.plane;
  float* da1z = daz2 + sz.plane;
  float* dwa = da1z + sz.plane;
  float* da1w = dwa + sz.plane;
  float* dhg = da1w + sz.plane;
  float* da2 = dhg + sz.plane;
  float* da1t = da2 + sz.plane;
  float* dc = da1t + sz.plane;
  const Workspace<S> w{dc + sz.cplane, sz.part, pack_buffers<S>(packed, L)};
  const S* m6 = static_cast<const S*>(P[M6]);
  auto mask6 = [&](int i) { return m6 + i * sz.plane; };
  auto cs = [](const void* p) { return static_cast<const S*>(p); };

  // ---- z2_conv2.2
  {
    auto kern = &gt_kernel<S, S>;
    ENC_LAUNCH(kern, dim3(blocks_for(sz.zplane32, 256)), dim3(256), st, cs(P[D_Z2G]), cs(P[P_Z2G]), da32,
               sz.zplane32);
    ENC_TRY(cudaGetLastError());
  }
  ENC_RC(wgrad<S>(da32, P[P_C2M], Cz, T32, FEAT, 0, FEAT, FEAT, 3, 1, 1, B, T32, G7, P[G_C22W2], w, st));
  ENC_RC(wgrad<S>(da32, P[P_HT], Ch, T32, 64, 0, FEAT, 64, 1, 1, 0, B, T32, G7, P[G_C22WR], w, st));
  ENC_RC(colsum<S>(da32, B, Cz, T32, P[G_BC22], st));
  {
    auto c = conv_args<S, float, float>(dx_operand<S>(da32, Cz, T32, P[W_C22W2], FEAT, FEAT, 3, 1), B, T32,
                                        FEAT, da1_32, Cz, T32);
    c.emul = cs(P[MC22]);
    c.egt = cs(P[P_C2]);
    ENC_TRY(launch_conv(c, G7, st, w.pack));
  }
  ENC_RC(wgrad<S>(da1_32, P[P_HT], Ch, T32, 64, 0, FEAT, 64, 3, 1, 1, B, T32, G7, P[G_C22W1], w, st));
  {
    auto c = conv_args<S, float, float>(dx_operand<S>(da1_32, Cz, T32, P[W_C22W1], FEAT, 64, 3, 1), B, T32,
                                        64, dHt, Ch, T32);
    c.b = dx_operand<S>(da32, Cz, T32, P[W_C22WR], FEAT, 64, 1, 0);
    ENC_TRY(launch_conv(c, G7, st, w.pack));
  }

  // ---- z2_conv2.1 (ConvTranspose1d k2 s2, weight [Cz, 64, 2])
  ENC_RC(colsum<S>(dHt, B, Ch, T32, P[G_BT], st));
  for (int k = 0; k < 2; ++k)
    ENC_RC(weight_grad<S>(dHt, Ch, T32, 2, k, P[P_HC], Cz, T16, FEAT, 0, FEAT, 1, 1, 0, B, T16, 64, G7,
                          static_cast<float*>(P[G_T]) + k, (long long)FEAT * 128, 2, 128, 0, w, st));
  {
    auto c = conv_args<S, float, float>(
        operand<S, float>(dHt, Ch, T32, 64, 0, P[W_T], (long long)FEAT * 128, 128, 2, 1, 64, 2, 2, 0), B, T16,
        FEAT, da16, Cz, T16);
    c.egt = cs(P[P_HC]);
    ENC_TRY(launch_conv(c, G7, st, w.pack));
  }

  // ---- z2_conv2.0 (identity residual)
  ENC_RC(wgrad<S>(da16, P[P_C1M], Cz, T16, FEAT, 0, FEAT, FEAT, 3, 1, 1, B, T16, G7, P[G_C20W2], w, st));
  {
    auto c = conv_args<S, float, float>(dx_operand<S>(da16, Cz, T16, P[W_C20W2], FEAT, FEAT, 3, 1), B, T16,
                                        FEAT, da1_16, Cz, T16);
    c.emul = cs(P[MC20]);
    c.egt = cs(P[P_C1]);
    ENC_TRY(launch_conv(c, G7, st, w.pack));
  }
  ENC_RC(wgrad<S>(da1_16, P[P_A], Cz, T16, FEAT, 0, FEAT, FEAT, 3, 1, 1, B, T16, G7, P[G_C20W1], w, st));
  {
    auto c = conv_args<S, float, float>(dx_operand<S>(da1_16, Cz, T16, P[W_C20W1], FEAT, FEAT, 3, 1), B, T16,
                                        FEAT, dA, Cz, T16);
    c.res = da16;
    ENC_TRY(launch_conv(c, G7, st, w.pack));
  }

  timer.mark();

  // ---- roi_align -> z2_conv1 output gradient (relu-masked)
  {
    auto kern = &roi_bwd_kernel<S>;
    ENC_LAUNCH(kern, dim3(blocks_for(sz.plane, 256)), dim3(256), st, dA, cs(P[RAMP]), cs(P[P_Z2F]), daz2, B, C);
    ENC_TRY(cudaGetLastError());
  }

  // ---- z1_conv.0 / z2_conv1.0, writing the two halves of w_conv's output gradient
  {
    auto kern = &gt_kernel<S, S>;
    ENC_LAUNCH(kern, dim3(blocks_for(sz.plane, 256)), dim3(256), st, cs(P[D_Z1]), cs(P[P_Z1F]), daz1, sz.plane);
    ENC_TRY(cudaGetLastError());
  }
  for (int z = 0; z < 2; ++z) {
    const float* da = z ? daz2 : daz1;
    const int zr1 = z ? P_ZR12 : P_ZR11, zr1m = z ? P_ZR1M2 : P_ZR1M1;
    const int w1 = z ? W_Z2W1 : W_Z1W1, w2 = z ? W_Z2W2 : W_Z1W2, wr = z ? W_Z2WR : W_Z1WR;
    ENC_RC(wgrad<S>(da, P[zr1m], C, T, FEAT, 0, FEAT, FEAT, 3, 1, 1, B, T, L, P[z ? G_Z2W2 : G_Z1W2], w, st));
    ENC_RC(wgrad<S>(da, P[P_HW], C, T, FEAT, 64 * z, FEAT, 64, 1, 1, 0, B, T, L, P[z ? G_Z2WR : G_Z1WR], w, st));
    ENC_RC(colsum<S>(da, B, C, T, P[z ? G_BZ2 : G_BZ1], st));
    {
      auto c = conv_args<S, float, float>(dx_operand<S>(da, C, T, P[w2], FEAT, FEAT, 3, 1), B, T, FEAT, da1z,
                                          C, T);
      c.emul = mask6(4 + z);
      c.egt = cs(P[zr1]);
      ENC_TRY(launch_conv(c, L, st, w.pack));
    }
    ENC_RC(wgrad<S>(da1z, P[P_HW], C, T, FEAT, 64 * z, FEAT, 64, 3, 1, 1, B, T, L, P[z ? G_Z2W1 : G_Z1W1], w, st));
    {
      auto c = conv_args<S, float, float>(dx_operand<S>(da1z, C, T, P[w1], FEAT, 64, 3, 1), B, T, 64, dwa, C, T);
      c.b = dx_operand<S>(da, C, T, P[wr], FEAT, 64, 1, 0);
      c.o_gs = FEAT;
      c.o_off = 64 * z;
      c.egt = cs(P[P_HW]);
      ENC_TRY(launch_conv(c, L, st, w.pack));
    }
  }

  timer.mark();

  // ---- w_conv.0 (identity residual)
  ENC_RC(wgrad<S>(dwa, P[P_WR1M], C, T, FEAT, 0, FEAT, FEAT, 3, 1, 1, B, T, L, P[G_WC2], w, st));
  {
    auto c = conv_args<S, float, float>(dx_operand<S>(dwa, C, T, P[W_WC2], FEAT, FEAT, 3, 1), B, T, FEAT, da1w,
                                        C, T);
    c.emul = mask6(3);
    c.egt = cs(P[P_WR1]);
    ENC_TRY(launch_conv(c, L, st, w.pack));
  }
  ENC_RC(wgrad<S>(da1w, P[P_HG], C, T, FEAT, 0, FEAT, FEAT, 3, 1, 1, B, T, L, P[G_WC1], w, st));
  {
    auto c = conv_args<S, float, float>(dx_operand<S>(da1w, C, T, P[W_WC1], FEAT, FEAT, 3, 1), B, T, FEAT, dhg,
                                        C, T);
    c.res = dwa;
    ENC_TRY(launch_conv(c, L, st, w.pack));
  }

  // ---- the gate: dgate = sum_t dhg * h3; into the tower: dhg * gate where h3 > 0
  {
    auto k1 = &rowdot_kernel<S>;
    ENC_LAUNCH(k1, dim3(B * C), dim3(128), st, dhg, cs(P[P_H3]), static_cast<float*>(P[G_GATE]), T);
    ENC_TRY(cudaGetLastError());
    auto k2 = &gate_bwd_kernel<S>;
    ENC_LAUNCH(k2, dim3(blocks_for(sz.plane, 256)), dim3(256), st, dhg, cs(P[GATE]), cs(P[P_H3]), da2, sz.plane,
               T);
    ENC_TRY(cudaGetLastError());
  }

  timer.mark();

  // ---- layer1, last block first; da2 holds the block output's gradient
  const int hs[3] = {P_H0, P_H1, P_H2};
  const int r1s[3] = {P_R1_0, P_R1_1, P_R1_2};
  const int r1ms[3] = {P_R1M_0, P_R1M_1, P_R1M_2};
  const int wk[6] = {W_L0C1, W_L0C2, W_L1C1, W_L1C2, W_L2C1, W_L2C2};
  const int gk[6] = {G_L0C1, G_L0C2, G_L1C1, G_L1C2, G_L2C1, G_L2C2};
  for (int b = 2; b >= 0; --b) {
    ENC_RC(wgrad<S>(da2, P[r1ms[b]], C, T, FEAT, 0, FEAT, FEAT, 7, 1, 3, B, T, L, P[gk[2 * b + 1]], w, st));
    {
      auto c = conv_args<S, float, float>(dx_operand<S>(da2, C, T, P[wk[2 * b + 1]], FEAT, FEAT, 7, 3), B, T,
                                          FEAT, da1t, C, T);
      c.emul = mask6(b);
      c.egt = cs(P[r1s[b]]);
      ENC_TRY(launch_conv(c, L, st, w.pack));
    }
    ENC_RC(wgrad<S>(da1t, P[hs[b]], C, T, FEAT, 0, FEAT, FEAT, 7, 1, 3, B, T, L, P[gk[2 * b]], w, st));
    {
      // in place: each output element reads only its own residual
      auto c = conv_args<S, float, float>(dx_operand<S>(da1t, C, T, P[wk[2 * b]], FEAT, FEAT, 7, 3), B, T,
                                          FEAT, da2, C, T);
      c.res = da2;
      if (b > 0) c.egt = cs(P[hs[b]]);
      ENC_TRY(launch_conv(c, L, st, w.pack));
    }
  }

  timer.mark();

  // ---- maxpool + conv1 (k15, s2, p7, one input channel per lead)
  {
    auto kern = &maxpool_bwd_kernel<S>;
    ENC_LAUNCH(kern, dim3(blocks_for(sz.cplane, 256)), dim3(256), st, static_cast<const float*>(da2),
               cs(P[P_C]), cs(P[P_H0]), dc, (long long)B * C);
    ENC_TRY(cudaGetLastError());
  }
  ENC_RC(wgrad<S>(dc, P[X], L, SEQ, 1, 0, FEAT, 1, 15, 2, 7, B, 2 * T, L, P[G_C1], w, st));
  timer.mark();
  return (int)timer.finish();
}

}  // namespace
}  // namespace enc

// Plain C interface (loaded with ctypes). `ptrs` is a host array of NPTR
// device pointers in the encoder_common.cuh enum order: the forward's inputs
// and masks, every P_* plane (checkpointed ones filled, the others scratch
// that `level` recomputes), the cotangents D_Z1, D_Z2G (storage type) and
// the float outputs G_GATE [B, L*128] and G_* (each in its weight's layout).
// `workspace` holds encoder_bwd_workspace_floats_f32(B, L) floats
// (encoder_bwd_workspace_floats_bf16 for encoder_bwd_bf16). section_ms:
// null, or a host array of 6 floats that receives the sections' times (the
// call then waits for the stream).
extern "C" long long encoder_bwd_workspace_floats_f32(int B, int L) { return enc::workspace_floats<float>(B, L); }
extern "C" long long encoder_bwd_workspace_floats_bf16(int B, int L) {
  return enc::workspace_floats<__nv_bfloat16>(B, L);
}

extern "C" int encoder_bwd_f32(void* const* ptrs, int B, int L, int level, void* workspace, void* section_ms,
                               void* stream) {
  enc::error_site() = enc::ErrorSite{};
  if (B <= 0 || L <= 0 || level < 0 || level > 2) return (int)cudaErrorInvalidValue;
  return enc::backward<float>(ptrs, B, L, level, static_cast<float*>(workspace),
                              static_cast<float*>(section_ms), static_cast<cudaStream_t>(stream));
}

extern "C" int encoder_bwd_bf16(void* const* ptrs, int B, int L, int level, void* workspace, void* section_ms,
                                void* stream) {
  enc::error_site() = enc::ErrorSite{};
  if (B <= 0 || L <= 0 || level < 0 || level > 2) return (int)cudaErrorInvalidValue;
  return enc::backward<__nv_bfloat16>(ptrs, B, L, level, static_cast<float*>(workspace),
                                      static_cast<float*>(section_ms), static_cast<cudaStream_t>(stream));
}

extern "C" int encoder_bwd_nptr() { return enc::NPTR; }

extern "C" const char* encoder_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* encoder_bwd_error_file() { return enc::error_site().file; }
extern "C" int encoder_bwd_error_line() { return enc::error_site().line; }

// Dynamic shared memory of one tensor-core conv block (encoder_tc.cuh) for a
// conv of cig input channels per group, K taps, this stride and Tout output
// steps; 0 where the conv does not run on the engine.
extern "C" int encoder_tc_smem_bytes(int cig, int K, int stride, int Tout) {
  const enc::tc::Geometry geo(cig, K, stride, Tout);
  return enc::tc::conv_ok(cig, 128, Tout) ? enc::tc::conv_smem_bytes(geo, nullptr) : 0;
}

// Dynamic shared memory of one tensor-core weight-gradient block for K taps
// and Tout steps; 0 where the gradient does not run on the engine.
extern "C" int encoder_tc_dw_smem_bytes(int K, int Tout) {
  return enc::tc::dw_ok(128, 128, K, 1, Tout) ? enc::tc::dw_smem_bytes(K, Tout) : 0;
}

// Dynamic shared memory of one FMA conv block (encoder_fma.cuh) for K taps
// at this stride and Tout output steps (a k1 second operand takes no more);
// 0 where the engine has no such taps.
extern "C" int encoder_fma_smem_bytes(int K, int stride, int Tout) {
  using namespace enc::fma;
  if (stride == 1 && K == 7) return conv_smem_bytes<7, 1>(Tout);
  if (stride == 1 && K == 3) return conv_smem_bytes<3, 1>(Tout);
  if (stride == 1 && K == 1) return conv_smem_bytes<1, 1>(Tout);
  if (stride == 2 && K == 2) return conv_smem_bytes<2, 2>(Tout);
  return 0;
}

// Dynamic shared memory of one FMA weight-gradient block for K taps; 0
// where the gradient does not run on the engine.
extern "C" int encoder_fma_dw_smem_bytes(int K) {
  return enc::fma::dw_ok(128, 128, K, 1, (K - 1) / 2, 16) ? enc::fma::dw_smem_bytes(K) : 0;
}
