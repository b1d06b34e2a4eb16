// Fused train-mode Nef-Net decoder, backward, for Hopper, sm_90a.
//
// Replaces the TPU kernel electrocardio_panorama_tpu/ops/pallas/decoder_train.py
// ::_train_bwd_kernel (via _bwd_call), the backward of train_decode_groups.
// The TPU kernel takes only (weights, x, dout) and recomputes the forward;
// this one reads the planes that the forward launch (decoder_train_fwd.cu)
// filled and the wrapper kept (a1..a4, h1..h4, out, mean, var), so it
// computes gradients only, and walks back:
//
//   dz   = dout * out * (1 - out) / 3
//   conv5: dw5, db5, dh4
//   for layers 4, 3, 2, 1: relu mask (bn output > 0), dgamma = sum dy * xhat,
//     dbeta = sum dy, da = (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) * inv
//     with the two means per (group, channel); then the conv's bias, weight
//     and data gradients, and for the two upsampled convs the adjoint of up2
//     (per sample, clamped edges) on the data gradient.
//
// It emits dx [G, 256, nb*128] and the 18 weight, bias and BN-affine gradients
// summed over the groups, all float. A gradient rounds to the storage type
// only where it is a product's operand (the conv data and weight gradients);
// bias sums, BN sums and the relu mask use it unrounded.
//
// Every reduction has a fixed order: per-(group, channel) sums by one block
// each, and each weight gradient as a GEMM over (sample, time) split into a
// fixed number of position ranges, per-block partials, and a second kernel
// that adds the partials in order. No atomics, so a repeat launch gives the
// same bits. In float32 the data gradients go through the forward's conv
// kernel with transposed, flipped weights, and the weight gradients through
// dw_kernel below; in bfloat16 both run on the tensor-core engine of
// decoder_train_tc.cuh.

#include <type_traits>

#include "decoder_train_common.cuh"

namespace dtr {
namespace {

constexpr int DW_P = 32;         // positions staged per step in the weight-gradient GEMM
constexpr int DW_T = 64;         // output channels / reduction rows per block
constexpr int MAX_SPLIT = 16;    // position ranges per weight gradient
constexpr int TARGET_BLOCKS = 264;

__global__ void sigmoid_bwd_kernel(const float* __restrict__ dout, const float* __restrict__ out,
                                   float* __restrict__ dz, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const float o = out[e];
  dz[e] = dout[e] * o * (1.0f - o) / 3.0f;
}

// dh4[n, c, t] = sum_k w5[k, c] * round_s(dz[n, t - k + 1]).
template <typename S>
__global__ void conv5_bwd_dh_kernel(const float* __restrict__ dz, const S* __restrict__ w5,
                                    float* __restrict__ dh, long long total, int T) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int t = (int)(e % T);
  const int c = (int)((e / T) % C2);
  const long long n = e / ((long long)C2 * T);
  const float* d = dz + n * T;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int tt = t - k + 1;
    if (tt >= 0 && tt < T) v = fmaf(ld(w5 + k * C2 + c), round_s<S>(d[tt]), v);
  }
  dh[e] = v;
}

// Block r < 3*C2: dw5[k, c] = sum over (n, t) of round_s(dz[n, t]) *
// round_s(h4[n, c, t + k - 1]), r = k*C2 + c; block 3*C2: db5 = sum dz.
template <typename S>
__global__ void conv5_bwd_dw_kernel(const float* __restrict__ dz, const float* __restrict__ h4,
                                    float* __restrict__ dw5, float* __restrict__ db5, int N, int T) {
  __shared__ float red[256];
  const int r = blockIdx.x;
  const long long P = (long long)N * T;
  float s = 0.f;
  if (r == 3 * C2) {
    for (long long p = threadIdx.x; p < P; p += blockDim.x) s += dz[p];
  } else {
    const int k = r / C2, c = r % C2;
    for (long long p = threadIdx.x; p < P; p += blockDim.x) {
      const long long n = p / T;
      const int tt = (int)(p % T) + k - 1;
      if (tt >= 0 && tt < T) s = fmaf(round_s<S>(dz[p]), round_s<S>(h4[(n * C2 + c) * T + tt]), s);
    }
  }
  const float total = block_sum(s, red);
  if (threadIdx.x == 0) {
    if (r == 3 * C2) db5[0] = total; else dw5[r] = total;
  }
}

// xhat and the relu-masked gradient of one element of a BN + relu layer.
__device__ __forceinline__ void bn_masked(float a, float m, float inv, float gamma, float beta, float dh,
                                          float* xhat, float* dy) {
  *xhat = (a - m) * inv;
  *dy = (*xhat * gamma + beta) > 0.f ? dh : 0.f;
}

// s1[g, c] = sum dy, s2[g, c] = sum dy * xhat over the group's (sample, time),
// dy the relu-masked gradient. grid: (C, G).
__global__ void bn_bwd_reduce_kernel(const float* __restrict__ a, const float* __restrict__ mean,
                                     const float* __restrict__ var, const float* __restrict__ gamma,
                                     const float* __restrict__ beta, const float* __restrict__ dh,
                                     float* __restrict__ s1, float* __restrict__ s2, int nb, int C,
                                     int T, int stat_sG) {
  __shared__ float red[256];
  const int c = blockIdx.x, g = blockIdx.y;
  const int n = nb * T;
  const float m = mean[g * stat_sG + c], inv = bn_inv(var[g * stat_sG + c]);
  const float ga = gamma[c], be = beta[c];
  const size_t base = ((size_t)g * nb * C + c) * T;
  float p1 = 0.f, p2 = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const size_t idx = base + (size_t)(e / T) * C * T + e % T;
    float xhat, dy;
    bn_masked(a[idx], m, inv, ga, be, dh[idx], &xhat, &dy);
    p1 += dy;
    p2 = fmaf(dy, xhat, p2);
  }
  const float t1 = block_sum(p1, red);
  const float t2 = block_sum(p2, red);
  if (threadIdx.x == 0) {
    s1[g * C + c] = t1;
    s2[g * C + c] = t2;
  }
}

// dgamma[c] = sum_g s2[g, c], dbeta[c] = sum_g s1[g, c], in group order.
__global__ void bn_affine_grad_kernel(const float* __restrict__ s1, const float* __restrict__ s2,
                                      float* __restrict__ dgamma, float* __restrict__ dbeta, int G, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float dg = 0.f, db = 0.f;
  for (int g = 0; g < G; ++g) {
    dg += s2[g * C + c];
    db += s1[g * C + c];
  }
  dgamma[c] = dg;
  dbeta[c] = db;
}

// da = (dy * gamma - m1 - xhat * m2) * inv, m1 = gamma * s1 / n, m2 = gamma * s2 / n.
__global__ void bn_bwd_kernel(const float* __restrict__ a, const float* __restrict__ mean,
                              const float* __restrict__ var, const float* __restrict__ gamma,
                              const float* __restrict__ beta, const float* __restrict__ dh,
                              const float* __restrict__ s1, const float* __restrict__ s2,
                              float* __restrict__ da, long long total, int nb, int C, int T, int stat_sG) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (int)((e / T) % C);
  const int g = (int)(e / ((long long)nb * C * T));
  const float inv = bn_inv(var[g * stat_sG + c]);
  const float ga = gamma[c];
  const float n = (float)(nb * T);
  float xhat, dy;
  bn_masked(a[e], mean[g * stat_sG + c], inv, ga, beta[c], dh[e], &xhat, &dy);
  const float m1 = ga * s1[g * C + c] / n, m2 = ga * s2[g * C + c] / n;
  da[e] = (dy * ga - m1 - xhat * m2) * inv;
}

// out[c] = sum over (n, t) of a[n, c, t]: a bias gradient (one block per channel).
__global__ void colsum_kernel(const float* __restrict__ a, float* __restrict__ out, int N, int C, int T) {
  __shared__ float red[256];
  const int c = blockIdx.x;
  float v = 0.f;
  for (int e = threadIdx.x; e < N * T; e += blockDim.x)
    v += a[((size_t)(e / T) * C + c) * T + e % T];
  const float s = block_sum(v, red);
  if (threadIdx.x == 0) out[c] = s;
}

// The adjoint of up2 per row: du [rows = samples*C, 2T] -> the [G, nb, C, T]
// tensor `out` with strides (sG, sB, sC), time contiguous.
__global__ void up2_adjoint_kernel(const float* __restrict__ du, float* __restrict__ out, long long total,
                                   int nb, int C, int T, long long sG, long long sB, long long sC) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int t = (int)(e % T);
  const int c = (int)((e / T) % C);
  const int n = (int)(e / ((long long)C * T));
  const float* d = du + (e / T) * 2 * T;
  const float v = 0.75f * (d[2 * t] + d[2 * t + 1]) + 0.25f * (t + 1 < T ? d[2 * t + 2] : d[2 * T - 1])
                  + 0.25f * (t > 0 ? d[2 * t - 1] : d[0]);
  out[(n / nb) * sG + (n % nb) * sB + c * sC + t] = v;
}

// Weight-gradient GEMM: for output channel o and row r = (i, k),
// part[z][o][r] = sum over positions p = n*T + t in range z of
//   round_s(dy[n, o, t]) * input(n, i, t + k - 1),
// input as the forward conv saw it (conv_input; zero outside [0, T)).
template <typename S>
struct DwArgs {
  const float* dy;
  View<S> x;
  int Cin, Cout, T, N, per;
  float* part;
};

// grid: (Cin*3 / DW_T, Cout / DW_T, ranges)
template <typename S, int UP>
__global__ void __launch_bounds__(THREADS) dw_kernel(DwArgs<S> a) {
  __shared__ float dys[DW_P][DW_T + 1];
  __shared__ float xs[DW_P][DW_T + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int r0 = blockIdx.x * DW_T;
  const int oc0 = blockIdx.y * DW_T;
  const int R = a.Cin * 3;
  const int P = a.N * a.T;
  const int lo = blockIdx.z * a.per, hi = min(P, lo + a.per);
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int q0 = lo; q0 < hi; q0 += DW_P) {
    __syncthreads();
    for (int e = tid; e < DW_P * DW_T; e += THREADS) {
      const int pp = e % DW_P, cc = e / DW_P;
      const int p = q0 + pp;
      float dv = 0.f, xv = 0.f;
      if (p < hi) {
        const int n = p / a.T, t = p - n * a.T;
        dv = round_s<S>(a.dy[((size_t)n * a.Cout + oc0 + cc) * a.T + t]);
        const int r = r0 + cc;
        if (r < R) {
          const int i = r / 3, k = r - 3 * i;
          const int ti = t + k - 1;
          if (ti >= 0 && ti < a.T) xv = conv_input<S, S, UP>(a.x, n, i, ti, a.T);
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
  float* part = a.part + (size_t)blockIdx.z * a.Cout * R;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int oc = oc0 + ty + 16 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + tx + 16 * i;
      if (r < R) part[(size_t)oc * R + r] = acc[j][i];
    }
  }
}

// Adds the ranges' partials in order and writes the gradient tap-major:
// (o, i, k) at out[(k*Cout + o)*Cin + i].
__global__ void dw_reduce_kernel(const float* __restrict__ part, int ranges, int Cout, int Cin,
                                 float* __restrict__ out) {
  const int n = Cout * Cin * 3;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < ranges; ++z) s += part[(size_t)z * n + e];
  const int R = Cin * 3;
  const int o = e / R, r = e - o * R;
  const int i = r / 3, k = r - 3 * i;
  out[((size_t)k * Cout + o) * Cin + i] = s;
}

template <typename S, int UP>
int weight_grad(const float* dy, const View<S>& x, int Cin, int Cout, int T, int N, void* out, float* part,
                cudaStream_t st) {
  DwArgs<S> a;
  a.dy = dy; a.x = x; a.Cin = Cin; a.Cout = Cout; a.T = T; a.N = N; a.part = part;
  const int R = Cin * 3, P = N * T;
  const int tiles = (R / DW_T) * (Cout / DW_T);
  int ranges = blocks_for(TARGET_BLOCKS, tiles);
  ranges = ranges < MAX_SPLIT ? ranges : MAX_SPLIT;
  const int max_ranges = blocks_for(P, DW_P);
  ranges = ranges < max_ranges ? ranges : max_ranges;
  a.per = blocks_for(blocks_for(P, ranges), DW_P) * DW_P;
  ranges = blocks_for(P, a.per);
  dw_kernel<S, UP><<<dim3(R / DW_T, Cout / DW_T, ranges), dim3(THREADS), 0, st>>>(a);
  DTR_TRY(cudaGetLastError());
  dw_reduce_kernel<<<dim3(blocks_for((long long)Cout * R, 256)), dim3(256), 0, st>>>(
      part, ranges, Cout, Cin, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// The data gradient of a forward conv with tap-major weights w [3, Cfo, Cfi]:
// a conv over dy [N, Cfo, T] with output channel i, rows (o, k') and weight
// w[2 - k', o, i]. Writes [N, Cfi, T].
template <typename S>
int data_grad(const float* dy, const void* w, float* out, int N, int nb, int Cfo, int Cfi, int T,
              cudaStream_t st) {
  const S* wf = static_cast<const S*>(w) + 2LL * Cfo * Cfi;
  conv3_kernel<S, float, 0><<<dim3(N, T / T_T, Cfi / CO_T), dim3(THREADS), 0, st>>>(
      planes<float>(dy, nb, Cfo, T), wf, -(long long)Cfo * Cfi, 1LL, (long long)Cfi, nullptr, out, Cfo,
      Cfi, T);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dtr

// the bf16 engine; it reduces its plain weight-gradient partials with
// dw_reduce_kernel above
#include "decoder_train_tc.cuh"

namespace dtr {
namespace {

struct Scratch {
  float *dz, *bufA, *bufB, *bufU, *s1, *s2, *part, *bias_part, *edges;
  __nv_bfloat16* wp;  // the tensor-core data gradient's packed weights
};

// the weight gradients' partials: the larger of the SIMT and the
// tensor-core engine's need
long long part_floats(int N) {
  long long n = (long long)MAX_SPLIT * C1 * C0 * 3;
  const long long tc[4] = {tc::part_floats(C1, C0, T0, N, 1), tc::part_floats(C1, C1, T1, N, 0),
                           tc::part_floats(C2, C1, T1, N, 1), tc::part_floats(C2, C2, T2, N, 0)};
  for (long long v : tc) n = n > v ? n : v;
  return n;
}

constexpr int BIAS_PART = tc::MAX_RANGES * 2 * C1;

// in order: dz, bufA, bufB, bufU, s1, s2, part, bias_part, edges, wp (every
// offset a multiple of four floats, for 16-byte loads)
long long workspace_floats(int G, int nb) {
  const long long N = (long long)G * nb;
  return N * T2 + 2 * N * C1 * T1 + N * C0 * T1 + 2LL * G * STAT_C + part_floats((int)N) + BIAS_PART +
         2 * N * (C1 + C0) + 3LL * C0 * C1 / 2;
}

// relu + BN backward of layer `layer`: dh -> da, and the affine gradients.
int bn_backward(void* const* P, int layer, const void* a, const void* gamma, const void* beta,
                const float* dh, float* da, void* dgamma, void* dbeta, const Scratch& w, int G, int nb,
                int C, int T, cudaStream_t st) {
  const float* mean = static_cast<const float*>(P[MEAN]) + layer * STAT_C;
  const float* var = static_cast<const float*>(P[VAR]) + layer * STAT_C;
  const int sG = 4 * STAT_C;
  const float* af = static_cast<const float*>(a);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  bn_bwd_reduce_kernel<<<dim3(C, G), dim3(256), 0, st>>>(af, mean, var, ga, be, dh, w.s1, w.s2, nb, C, T, sG);
  DTR_TRY(cudaGetLastError());
  bn_affine_grad_kernel<<<dim3(blocks_for(C, 128)), dim3(128), 0, st>>>(
      w.s1, w.s2, static_cast<float*>(dgamma), static_cast<float*>(dbeta), G, C);
  DTR_TRY(cudaGetLastError());
  const long long total = (long long)G * nb * C * T;
  bn_bwd_kernel<<<dim3(blocks_for(total, 256)), dim3(256), 0, st>>>(af, mean, var, ga, be, dh, w.s1, w.s2, da,
                                                                    total, nb, C, T, sG);
  return (int)cudaGetLastError();
}

int colsum(const float* a, int N, int C, int T, void* out, cudaStream_t st) {
  colsum_kernel<<<dim3(C), dim3(256), 0, st>>>(a, static_cast<float*>(out), N, C, T);
  return (int)cudaGetLastError();
}

int up2_adjoint(const float* du, float* out, int N, int nb, int C, int T, long long sG, long long sB,
                long long sC, cudaStream_t st) {
  const long long total = (long long)N * C * T;
  up2_adjoint_kernel<<<dim3(blocks_for(total, 256)), dim3(256), 0, st>>>(du, out, total, nb, C, T, sG, sB, sC);
  return (int)cudaGetLastError();
}

// A conv's bias and weight gradients (weight_grad_s) and its data gradient
// (data_grad_s): the tensor-core engine in bf16, the SIMT kernels in float32.
template <typename S, int UP>
int weight_grad_s(const float* dy, const View<S>& x, int Cin, int Cout, int T, int N, void* out, void* bias_out,
                  const Scratch& w, cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    return tc::weight_grad(dy, x, Cin, Cout, T, N, UP, out, bias_out, w.part, w.bias_part, w.edges, st);
  } else {
    DTR_RC(colsum(dy, N, Cout, T, bias_out, st));
    return weight_grad<S, UP>(dy, x, Cin, Cout, T, N, out, w.part, st);
  }
}

template <typename S>
int data_grad_s(const float* dy, const void* wt, float* out, int N, int nb, int Cfo, int Cfi, int T,
                const Scratch& w, cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return tc::data_grad(dy, wt, out, N, Cfo, Cfi, T, w.wp, st);
  else
    return data_grad<S>(dy, wt, out, N, nb, Cfo, Cfi, T, st);
}

template <typename S>
int backward(void* const* P, int G, int nb, float* wsp, cudaStream_t st) {
  const int N = G * nb;
  Scratch w;
  w.dz = wsp;
  w.bufA = w.dz + (long long)N * T2;
  w.bufB = w.bufA + (long long)N * C1 * T1;
  w.bufU = w.bufB + (long long)N * C1 * T1;
  w.s1 = w.bufU + (long long)N * C0 * T1;
  w.s2 = w.s1 + G * STAT_C;
  w.part = w.s2 + G * STAT_C;
  w.bias_part = w.part + part_floats(N);
  w.edges = w.bias_part + BIAS_PART;
  w.wp = reinterpret_cast<__nv_bfloat16*>(w.edges + 2LL * N * (C1 + C0));

  // ---- sigmoid and conv5
  sigmoid_bwd_kernel<<<dim3(blocks_for((long long)N * T2, 256)), dim3(256), 0, st>>>(
      static_cast<const float*>(P[DOUT]), static_cast<const float*>(P[OUT]), w.dz, (long long)N * T2);
  DTR_TRY(cudaGetLastError());
  conv5_bwd_dw_kernel<S><<<dim3(3 * C2 + 1), dim3(256), 0, st>>>(
      w.dz, static_cast<const float*>(P[P_H4]), static_cast<float*>(P[GW5]), static_cast<float*>(P[GB5]), N, T2);
  DTR_TRY(cudaGetLastError());
  {
    const long long total = (long long)N * C2 * T2;
    conv5_bwd_dh_kernel<S><<<dim3(blocks_for(total, 256)), dim3(256), 0, st>>>(
        w.dz, static_cast<const S*>(P[W5]), w.bufA, total, T2);
    DTR_TRY(cudaGetLastError());
  }

  // ---- BN4 + relu, conv4
  DTR_RC(bn_backward(P, 3, P[P_A4], P[G4], P[O4], w.bufA, w.bufB, P[GG4], P[GO4], w, G, nb, C2, T2, st));
  DTR_RC((weight_grad_s<S, 0>(w.bufB, planes<S>(P[P_H3], nb, C2, T2), C2, C2, T2, N, P[GW4], P[GB4], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W4], w.bufA, N, nb, C2, C2, T2, w, st));

  // ---- BN3 + relu, conv3 on up2(h2)
  DTR_RC(bn_backward(P, 2, P[P_A3], P[G3], P[O3], w.bufA, w.bufB, P[GG3], P[GO3], w, G, nb, C2, T2, st));
  DTR_RC((weight_grad_s<S, 1>(w.bufB, planes<S>(P[P_H2], nb, C1, T1), C1, C2, T2, N, P[GW3], P[GB3], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W3], w.bufU, N, nb, C2, C1, T2, w, st));
  DTR_RC(up2_adjoint(w.bufU, w.bufA, N, nb, C1, T1, (long long)nb * C1 * T1, (long long)C1 * T1, T1, st));

  // ---- BN2 + relu, conv2
  DTR_RC(bn_backward(P, 1, P[P_A2], P[G2], P[O2], w.bufA, w.bufB, P[GG2], P[GO2], w, G, nb, C1, T1, st));
  DTR_RC((weight_grad_s<S, 0>(w.bufB, planes<S>(P[P_H1], nb, C1, T1), C1, C1, T1, N, P[GW2], P[GB2], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W2], w.bufA, N, nb, C1, C1, T1, w, st));

  // ---- BN1 + relu, conv1 on up2(x); dx in x's layout [G, 256, nb*128]
  DTR_RC(bn_backward(P, 0, P[P_A1], P[G1], P[O1], w.bufA, w.bufB, P[GG1], P[GO1], w, G, nb, C1, T1, st));
  DTR_RC((weight_grad_s<S, 1>(w.bufB, grouped<S>(P[X], nb, C0, T0), C0, C1, T1, N, P[GW1], P[GB1], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W1], w.bufU, N, nb, C1, C0, T1, w, st));
  return up2_adjoint(w.bufU, static_cast<float*>(P[DX]), N, nb, C0, T0, (long long)C0 * nb * T0, T0,
                     (long long)nb * T0, st);
}

}  // namespace
}  // namespace dtr

// Plain C interface (loaded with ctypes). `ptrs` is a host array of
// dtr::NPTR device pointers in the enum order of decoder_train_common.cuh:
// the forward's inputs; its planes, out, mean and var as the forward launch
// left them (read only); dout [G, nb, 512] f32; and the float outputs dx
// [G, 256, nb*128], dw1..dw5 [3, Cout, Cin], the bias and BN-affine gradients
// [Cout]. `workspace` holds decoder_train_bwd_workspace_floats(G, nb) floats.
extern "C" long long decoder_train_bwd_workspace_floats(int G, int nb) {
  return dtr::workspace_floats(G, nb);
}

extern "C" int decoder_train_bwd_f32(void* const* ptrs, int G, int nb, void* workspace, void* stream) {
  if (G <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  return dtr::backward<float>(ptrs, G, nb, static_cast<float*>(workspace), static_cast<cudaStream_t>(stream));
}

extern "C" int decoder_train_bwd_bf16(void* const* ptrs, int G, int nb, void* workspace, void* stream) {
  if (G <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  return dtr::backward<__nv_bfloat16>(ptrs, G, nb, static_cast<float*>(workspace),
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int decoder_train_bwd_nptr() { return dtr::NPTR; }

extern "C" const char* decoder_train_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
