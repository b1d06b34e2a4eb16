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
// same bits. The conv data and weight gradients, and the conv biases'
// gradients with them, run on the engine of the storage type: the FMA engine
// of decoder_train_fma.cuh in float32, the tensor-core engine of
// decoder_train_tc.cuh in bfloat16; the stages here are shared by both.

#include <initializer_list>
#include <type_traits>

#include "decoder_train_common.cuh"
#include "decoder_train_fma.cuh"
#include "decoder_train_tc.cuh"

namespace dtr {
namespace {

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

struct Scratch {
  float *dz, *bufA, *bufB, *bufU, *s1, *s2, *part, *bias_part;
  float* bufX;        // float32: the upsampled conv's input plane, up2(h2) then up2(x)
  float* edges;       // bfloat16: the upsampled weight gradients' end terms
  __nv_bfloat16* wp;  // bfloat16: the data gradient's packed weights
};

long long most(std::initializer_list<long long> v) {
  long long n = 0;
  for (long long x : v) n = n > x ? n : x;
  return n;
}

// The weight gradients' partials of the storage type's engine, and its bias
// sums' partials: the most any of conv1..conv4 needs.
template <typename S>
long long part_floats(int N) {
  if (std::is_same<S, __nv_bfloat16>::value)
    return most({tc::part_floats(C1, C0, T0, N, 1), tc::part_floats(C1, C1, T1, N, 0),
                 tc::part_floats(C2, C1, T1, N, 1), tc::part_floats(C2, C2, T2, N, 0)});
  return most({fma::part_floats(C1, C0, T1, N), fma::part_floats(C1, C1, T1, N), fma::part_floats(C2, C1, T2, N),
               fma::part_floats(C2, C2, T2, N)});
}

template <typename S>
long long bias_part_floats(int N) {
  if (std::is_same<S, __nv_bfloat16>::value) return (long long)tc::MAX_RANGES * 2 * C1;
  return most({fma::bias_part_floats(C1, C0, T1, N), fma::bias_part_floats(C1, C1, T1, N),
               fma::bias_part_floats(C2, C1, T2, N), fma::bias_part_floats(C2, C2, T2, N)});
}

// The workspace of one launch, in order: dz, bufA, bufB, bufU, s1, s2, part,
// bias_part, then bufX (float32) or edges and wp (bfloat16), every piece
// rounded up to a multiple of four floats (16-byte loads). Returns its size in
// floats; with a base, also points w's pieces into it.
template <typename S>
long long layout(int G, int nb, float* base, Scratch* w) {
  constexpr bool bf16 = std::is_same<S, __nv_bfloat16>::value;
  const long long N = (long long)G * nb;
  long long at = 0;
  auto take = [&](long long n) {
    float* p = base != nullptr ? base + at : nullptr;
    at += (n + 3) / 4 * 4;
    return p;
  };
  Scratch s{};
  s.dz = take(N * T2);
  s.bufA = take(N * C1 * T1);
  s.bufB = take(N * C1 * T1);
  s.bufU = take(N * C0 * T1);
  s.s1 = take((long long)G * STAT_C);
  s.s2 = take((long long)G * STAT_C);
  s.part = take(part_floats<S>((int)N));
  s.bias_part = take(bias_part_floats<S>((int)N));
  if (bf16) {
    s.edges = take(2 * N * (C1 + C0));
    s.wp = reinterpret_cast<__nv_bfloat16*>(take(3LL * C0 * C1 / 2));
  } else {
    s.bufX = take(N * C0 * T1);  // = N * C1 * T2
  }
  if (w != nullptr) *w = s;
  return at;
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

int up2_adjoint(const float* du, float* out, int N, int nb, int C, int T, long long sG, long long sB,
                long long sC, cudaStream_t st) {
  const long long total = (long long)N * C * T;
  up2_adjoint_kernel<<<dim3(blocks_for(total, 256)), dim3(256), 0, st>>>(du, out, total, nb, C, T, sG, sB, sC);
  return (int)cudaGetLastError();
}

// A conv's bias and weight gradients (weight_grad_s) and its data gradient
// (data_grad_s) on the engine of the storage type.
template <typename S, int UP>
int weight_grad_s(const float* dy, const View<S>& x, int Cin, int Cout, int T, int N, void* out, void* bias_out,
                  const Scratch& w, cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    return tc::weight_grad(dy, x, Cin, Cout, T, N, UP, out, bias_out, w.part, w.bias_part, w.edges, st);
  } else {
    const float* xp = x.p;  // a planes view: [N, Cin, T]
    if (UP) {
      DTR_RC(fma::up2_plane(x, w.bufX, N, Cin, T, st));
      xp = w.bufX;
    }
    return fma::weight_grad(dy, xp, Cin, Cout, T, N, out, bias_out, w.part, w.bias_part, st);
  }
}

template <typename S>
int data_grad_s(const float* dy, const void* wt, float* out, int N, int Cfo, int Cfi, int T, const Scratch& w,
                cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value)
    return tc::data_grad(dy, wt, out, N, Cfo, Cfi, T, w.wp, st);
  else
    return fma::data_grad(dy, static_cast<const float*>(wt), out, N, Cfo, Cfi, T, st);
}

template <typename S>
int backward(void* const* P, int G, int nb, float* wsp, cudaStream_t st) {
  const int N = G * nb;
  Scratch w;
  layout<S>(G, nb, wsp, &w);

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
  DTR_RC(data_grad_s<S>(w.bufB, P[W4], w.bufA, N, C2, C2, T2, w, st));

  // ---- BN3 + relu, conv3 on up2(h2)
  DTR_RC(bn_backward(P, 2, P[P_A3], P[G3], P[O3], w.bufA, w.bufB, P[GG3], P[GO3], w, G, nb, C2, T2, st));
  DTR_RC((weight_grad_s<S, 1>(w.bufB, planes<S>(P[P_H2], nb, C1, T1), C1, C2, T2, N, P[GW3], P[GB3], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W3], w.bufU, N, C2, C1, T2, w, st));
  DTR_RC(up2_adjoint(w.bufU, w.bufA, N, nb, C1, T1, (long long)nb * C1 * T1, (long long)C1 * T1, T1, st));

  // ---- BN2 + relu, conv2
  DTR_RC(bn_backward(P, 1, P[P_A2], P[G2], P[O2], w.bufA, w.bufB, P[GG2], P[GO2], w, G, nb, C1, T1, st));
  DTR_RC((weight_grad_s<S, 0>(w.bufB, planes<S>(P[P_H1], nb, C1, T1), C1, C1, T1, N, P[GW2], P[GB2], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W2], w.bufA, N, C1, C1, T1, w, st));

  // ---- BN1 + relu, conv1 on up2(x); dx in x's layout [G, 256, nb*128]
  DTR_RC(bn_backward(P, 0, P[P_A1], P[G1], P[O1], w.bufA, w.bufB, P[GG1], P[GO1], w, G, nb, C1, T1, st));
  DTR_RC((weight_grad_s<S, 1>(w.bufB, grouped<S>(P[X], nb, C0, T0), C0, C1, T1, N, P[GW1], P[GB1], w, st)));
  DTR_RC(data_grad_s<S>(w.bufB, P[W1], w.bufU, N, C1, C0, T1, w, st));
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
// [Cout]. `workspace` holds decoder_train_bwd_workspace_floats_<dtype>(G, nb)
// floats.
extern "C" long long decoder_train_bwd_workspace_floats_f32(int G, int nb) {
  return dtr::layout<float>(G, nb, nullptr, nullptr);
}

extern "C" long long decoder_train_bwd_workspace_floats_bf16(int G, int nb) {
  return dtr::layout<__nv_bfloat16>(G, nb, nullptr, nullptr);
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

// The float32 engine's weight gradient at (Cout, Cin, T) over N samples: its
// blocks, and the blocks of it (dw = 1) or of the data gradient (dw = 0) that
// one SM holds at once on this device.
extern "C" int decoder_train_bwd_fma_dw_blocks(int Cout, int Cin, int T, int N) {
  return (Cin / dtr::fma::BI) * (Cout / dtr::fma::BO) * dtr::fma::dw_ranges(Cout, Cin, T, N);
}

extern "C" int decoder_train_bwd_fma_blocks_per_sm(int dw) {
  int n = 0;
  cudaError_t e;
  if (dw) {
    e = cudaFuncSetAttribute(dtr::fma::dw_kernel_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dtr::fma::DW_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dtr::fma::dw_kernel_fma, dtr::fma::DW_THREADS,
                                                        dtr::fma::DW_SMEM);
  } else {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dtr::fma::dgrad_kernel_fma, dtr::fma::THREADS, 0);
  }
  return e == cudaSuccess ? n : -(int)e;
}

extern "C" int decoder_train_bwd_fma_dw_smem_bytes() { return dtr::fma::DW_SMEM; }
