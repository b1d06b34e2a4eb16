// Fused train-mode Nef-Net decoder, forward, for Hopper, sm_90a.
//
// Replaces the TPU kernel electrocardio_panorama_tpu/ops/pallas/decoder_train.py
// ::_train_fwd_kernel (via _fwd_call): the three grouped decodes of a train
// step with BatchNorm on per-group batch statistics, returning the
// post-sigmoid output and every BN layer's biased batch moments. The chain,
// its rounding points and its bound are described in decoder_train_common.cuh.
// The four conv stages run on the engine of the storage type: in float32 the
// FMA engine of decoder_train_fma.cuh (the upsampled convs over up2 planes
// materialized in the workspace, the weights packed per launch), in bfloat16
// the tensor-core engine of decoder_train_tc.cuh (conv_fwd_kernel_tc, the
// upsampled convs at input resolution, the weights packed per launch into
// the workspace). The moments, BatchNorm + relu, conv5 and the sigmoid are
// the SIMT kernels below in both.

#include <type_traits>

#include "decoder_train_common.cuh"
#include "decoder_train_fma.cuh"
#include "decoder_train_tc.cuh"

namespace dtr {

// Moments of a [G*nb, C, T] over each group's (sample, time): mean and
// biased variance, written at mean[g*stat_sG + c] / var[...]. grid: (C, G).
__global__ void bn_stats_kernel(const float* __restrict__ a, float* __restrict__ mean,
                                float* __restrict__ var, int nb, int C, int T, int stat_sG) {
  __shared__ float red[256];
  const int c = blockIdx.x, g = blockIdx.y;
  const int n = nb * T;
  const float* base = a + ((size_t)g * nb * C + c) * T;
  float s = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) s += base[(size_t)(e / T) * C * T + e % T];
  const float m = block_sum(s, red) / n;
  float q = 0.f;
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float d = base[(size_t)(e / T) * C * T + e % T] - m;
    q = fmaf(d, d, q);
  }
  const float v = block_sum(q, red) / n;
  if (threadIdx.x == 0) {
    mean[g * stat_sG + c] = m;
    var[g * stat_sG + c] = v;
  }
}

// h = relu(xhat * gamma + beta), xhat = (a - mean) * inv, stored as TO
// (rounded when TO is bf16). Elementwise over [G*nb, C, T].
template <typename TO>
__global__ void bn_relu_kernel(const float* __restrict__ a, const float* __restrict__ mean,
                               const float* __restrict__ var, const float* __restrict__ gamma,
                               const float* __restrict__ beta, TO* __restrict__ h, long long total,
                               int nb, int C, int T, int stat_sG) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int c = (int)((e / T) % C);
  const int g = (int)(e / ((long long)nb * C * T));
  const float xhat = (a[e] - mean[g * stat_sG + c]) * bn_inv(var[g * stat_sG + c]);
  st(h + e, fmaxf(xhat * gamma[c] + beta[c], 0.f));
}

// conv5 (Cout = 1) on round_s(h4) + sigmoid(x / 3). grid: (samples, T / blockDim.x).
template <typename S>
__global__ void conv5_sigmoid_kernel(const float* __restrict__ h4, const S* __restrict__ w,
                                     const float* __restrict__ b5, float* __restrict__ out, int T) {
  __shared__ float ws[3][C2];
  const int n = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  for (int e = threadIdx.x; e < 3 * C2; e += blockDim.x) ws[e / C2][e % C2] = ld(w + e);
  __syncthreads();
  if (t >= T) return;
  const float* x = h4 + (size_t)n * C2 * T;
  float acc = 0.f;
  for (int c = 0; c < C2; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int tt = t + k - 1;
      if (tt >= 0 && tt < T) acc = fmaf(ws[k][c], round_s<S>(x[(size_t)c * T + tt]), acc);
    }
  }
  const float v = (acc + b5[0]) / 3.0f;
  out[(size_t)n * T + t] = 1.0f / (1.0f + expf(-v));
}

// Moments of layer `layer` (0..3) of plane a, then h = relu(bn(a)) as TO.
template <typename TO>
int bn_layer(void* const* P, int layer, const void* a, const void* gamma, const void* beta, void* h,
             int G, int nb, int C, int T, cudaStream_t st) {
  float* mean = static_cast<float*>(P[MEAN]) + layer * STAT_C;
  float* var = static_cast<float*>(P[VAR]) + layer * STAT_C;
  const int sG = 4 * STAT_C;
  bn_stats_kernel<<<dim3(C, G), dim3(256), 0, st>>>(static_cast<const float*>(a), mean, var, nb, C, T, sG);
  DTR_TRY(cudaGetLastError());
  const long long total = (long long)G * nb * C * T;
  bn_relu_kernel<TO><<<dim3(blocks_for(total, 256)), dim3(256), 0, st>>>(
      static_cast<const float*>(a), mean, var, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<TO*>(h), total, nb, C, T, sG);
  return (int)cudaGetLastError();
}

// The float32 forward's workspace, in floats: the upsampled conv's input
// plane (up2(x) [N, 256, 256], then up2(h2) [N, 128, 512]), then the packed
// weights of the largest conv.
inline long long fwd_workspace_floats(int G, int nb) { return (long long)G * nb * C0 * T1 + 3LL * C0 * C1; }

// The bfloat16 forward's workspace, in floats: the packed bf16 weights of
// the largest conv.
constexpr long long FWD_WORKSPACE_FLOATS_BF16 = 3LL * C0 * C1 / 2;

// A conv stage on the engine of the storage type; ws is the workspace
// (fwd_workspace_floats, or FWD_WORKSPACE_FLOATS_BF16 in bfloat16).
template <typename S, int UP>
int conv_s(const View<S>& in, const void* w, const void* bias, void* out, int N, int Cin, int Cout, int T,
           float* ws, cudaStream_t st) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    return tc::forward_conv<UP>(in, w, bias, static_cast<float*>(out), N, Cin, Cout, T,
                                reinterpret_cast<__nv_bfloat16*>(ws), st);
  } else {
    const float* xp = in.p;  // a planes view: [N, Cin, T]
    if (UP) {
      DTR_RC(fma::up2_plane(in, ws, N, Cin, T, st));
      xp = ws;
    }
    return fma::forward_conv(xp, static_cast<const float*>(w), static_cast<const float*>(bias),
                             ws + (long long)N * C0 * T1, static_cast<float*>(out), N, Cin, Cout, T, st);
  }
}

// The forward chain: fills P_A1..P_H4, OUT, and the used channels of MEAN
// and VAR [G, 4, 128] (the wrapper zero-fills the padding).
template <typename S>
int forward_chain(void* const* P, int G, int nb, float* ws, cudaStream_t st) {
  const int N = G * nb;
  DTR_RC((conv_s<S, 1>(grouped<S>(P[X], nb, C0, T0), P[W1], P[B1], P[P_A1], N, C0, C1, T1, ws, st)));
  DTR_RC(bn_layer<S>(P, 0, P[P_A1], P[G1], P[O1], P[P_H1], G, nb, C1, T1, st));
  DTR_RC((conv_s<S, 0>(planes<S>(P[P_H1], nb, C1, T1), P[W2], P[B2], P[P_A2], N, C1, C1, T1, ws, st)));
  DTR_RC(bn_layer<S>(P, 1, P[P_A2], P[G2], P[O2], P[P_H2], G, nb, C1, T1, st));
  DTR_RC((conv_s<S, 1>(planes<S>(P[P_H2], nb, C1, T1), P[W3], P[B3], P[P_A3], N, C1, C2, T2, ws, st)));
  DTR_RC(bn_layer<S>(P, 2, P[P_A3], P[G3], P[O3], P[P_H3], G, nb, C2, T2, st));
  DTR_RC((conv_s<S, 0>(planes<S>(P[P_H3], nb, C2, T2), P[W4], P[B4], P[P_A4], N, C2, C2, T2, ws, st)));
  DTR_RC(bn_layer<float>(P, 3, P[P_A4], P[G4], P[O4], P[P_H4], G, nb, C2, T2, st));
  conv5_sigmoid_kernel<S><<<dim3(N, T2 / 128), dim3(128), 0, st>>>(
      static_cast<const float*>(P[P_H4]), static_cast<const S*>(P[W5]), static_cast<const float*>(P[B5]),
      static_cast<float*>(P[OUT]), T2);
  return (int)cudaGetLastError();
}

}  // namespace dtr

// Plain C interface (loaded with ctypes). `ptrs` is a host array of
// dtr::NPTR device pointers in the enum order of decoder_train_common.cuh:
// x [G, 256, nb*128] S; w1..w5 [3, Cout, Cin] S; biases and BN affines f32;
// scratch a1, a2 [G*nb, 128, 256] and a3, a4 [G*nb, 64, 512] f32, h1, h2, h3 in
// S and h4 f32 of the same shapes; outputs out [G, nb, 512] f32 and mean, var
// [G, 4, 128] f32, zero-filled by the caller (channels 64..127 of layers 3 and
// 4 stay zero). The backward's entries of the table are not read. `workspace`
// holds decoder_train_fwd_workspace_floats_<dtype>(G, nb) floats. Returns 0
// or the cudaError_t of the first failed launch.
extern "C" long long decoder_train_fwd_workspace_floats_f32(int G, int nb) {
  return dtr::fwd_workspace_floats(G, nb);
}

extern "C" long long decoder_train_fwd_workspace_floats_bf16(int, int) { return dtr::FWD_WORKSPACE_FLOATS_BF16; }

extern "C" int decoder_train_fwd_f32(void* const* ptrs, int G, int nb, void* workspace, void* stream) {
  if (G <= 0 || nb <= 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
  return dtr::forward_chain<float>(ptrs, G, nb, static_cast<float*>(workspace), static_cast<cudaStream_t>(stream));
}

extern "C" int decoder_train_fwd_bf16(void* const* ptrs, int G, int nb, void* workspace, void* stream) {
  if (G <= 0 || nb <= 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
  return dtr::forward_chain<__nv_bfloat16>(ptrs, G, nb, static_cast<float*>(workspace),
                                           static_cast<cudaStream_t>(stream));
}

extern "C" int decoder_train_fwd_nptr() { return dtr::NPTR; }

extern "C" const char* decoder_train_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The float32 forward conv kernel's resources on this device: out[0..3] =
// registers per thread, local memory bytes per thread (spills), static shared
// memory bytes, and the blocks one SM holds at once. Returns 0 or a
// cudaError_t.
extern "C" int decoder_train_fwd_fma_resources(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, dtr::fma::conv_fwd_kernel_fma);
  int n = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, dtr::fma::conv_fwd_kernel_fma, dtr::fma::THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = n;
  return 0;
}

// The bfloat16 forward conv kernel's resources on this device, for the plain
// convs (up 0) or the upsampled ones (up 1): out[0..4] = registers per
// thread, local memory bytes per thread (spills), static shared memory
// bytes, the dynamic shared memory bytes of its largest launch (conv2 or
// conv1), and the blocks one SM holds at once with those. Returns 0 or a
// cudaError_t.
extern "C" int decoder_train_fwd_tc_resources(int up, int* out) {
  const void* fn = up ? reinterpret_cast<const void*>(dtr::tc::conv_fwd_kernel_tc<1>)
                      : reinterpret_cast<const void*>(dtr::tc::conv_fwd_kernel_tc<0>);
  const int bytes = dtr::tc::fwd_smem_bytes(up, up ? dtr::C0 : dtr::C1);
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, fn);
  int n = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, dtr::tc::THREADS, bytes);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = bytes;
  out[4] = n;
  return 0;
}
