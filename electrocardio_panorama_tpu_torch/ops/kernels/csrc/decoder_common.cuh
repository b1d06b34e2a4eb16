// Shared stages of the eval Nef-Net decoder kernels for Hopper, sm_90a:
// the streamed-basis form (decoder_basis.cu) and the gate-input and y1 forms
// (decoder_forms.cu). All of them end in the same chain
//
//   h2     = relu(conv3(y1; w2) + b2)                       [128, 256]
//   h3     = relu(conv3(up2(h2); w3) + b3)                  [ 64, 512]
//   h4     = relu(conv3(h3; w4) + b4)                       [ 64, 512]
//   out[v] = sigmoid((conv3(h4; w5) + b5) / 3)              [512]
//
// (the TPU kernels' _pp_tail) and differ in how y1 [128, 256] comes about.
//
// conv3 is a kernel-3, padding-1 convolution over time with tap-major weights
// w[3, Cout, Cin] (BatchNorm already folded in); up2 is torch's
// Upsample(x2, linear, align_corners=False) with edge clamp. Everything is in
// plain time order: the TPU kernels' [e|o] lane layout, polyphase matrices
// and selector matmuls exist for Mosaic and have no counterpart here.
//
// S is the storage type: float, or __nv_bfloat16 with float accumulation.
// In the bf16 instantiation values round to bf16 where the TPU kernels round
// them (y1, the conv2 and conv3 outputs, and conv5's operands, i.e. the conv4
// output); every product and sum is float. The f32 instantiation is plain
// FMA at full float32 (no TF32, no tensor cores).
//
// Direct SIMT convolution, one kernel per stage with the intermediate planes
// in device memory. Each block computes a 64-channel x 64-step output tile,
// staging 16 input channels (with the two halo steps) and their weights in
// shared memory per step, and each thread accumulates a 4 x 4 register tile.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dec {

constexpr int CO_T = 64;   // output channels per block
constexpr int T_T = 64;    // output time steps per block
constexpr int CI_T = 16;   // input channels staged per step
constexpr int THREADS = 256;
constexpr int MAXJ = 32;   // basis planes; 13 at theta_L=1
constexpr int MAXC5 = 64;  // conv5 input channels

enum Mode { MIX = 0, UP = 1, PLAIN = 2, GATE = 3 };

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename S> __device__ __forceinline__ float round_s(float v);
template <> __device__ __forceinline__ float round_s<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_s<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One conv3 + bias + ReLU stage. The input at conv position t (0 <= t < T) is
//   MIX:   round_s(relu(sum_j ep[n, j] * U[n / views, j, ci, t] + b1[ci]))
//   UP:    up2(x[n, ci, :T/2])[t]
//   PLAIN: x[n, ci, t]
//   GATE:  up2(round_s(ep[n, ci] * x[n / views, ci, :T/2]))[t]
//          (ep holds the view's gate, one value per input channel)
// and zero outside [0, T) (the conv's padding).
template <typename S, int MODE>
__global__ void __launch_bounds__(THREADS)
conv3_relu_kernel(const S* __restrict__ in, const float* __restrict__ ep,
                  const float* __restrict__ b1, int J, int views,
                  const S* __restrict__ w, const float* __restrict__ bias,
                  S* __restrict__ out, int Cin, int Cout, int T) {
  __shared__ float xs[CI_T][T_T + 2];
  __shared__ float ws[3][CI_T][CO_T];
  __shared__ float eps[MAXJ];

  const int n = blockIdx.x;
  const int t0 = blockIdx.y * T_T;
  const int co0 = blockIdx.z * CO_T;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  const S* src;
  if (MODE == MIX) {
    if (tid < J) eps[tid] = ep[(size_t)n * J + tid];
    src = in + (size_t)(n / views) * J * Cin * T;
  } else if (MODE == GATE) {
    src = in + (size_t)(n / views) * Cin * (T / 2);
  } else {
    src = in + (size_t)n * Cin * (MODE == UP ? T / 2 : T);
  }

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI_T) {
    __syncthreads();  // previous step's tiles are consumed; eps is visible
    for (int e = tid; e < CI_T * (T_T + 2); e += THREADS) {
      const int ci = e / (T_T + 2), s = e % (T_T + 2);
      const int c = ci0 + ci, t = t0 + s - 1;
      float v = 0.f;
      if (c < Cin && t >= 0 && t < T) {
        if (MODE == MIX) {
          float a = 0.f;
          for (int j = 0; j < J; ++j)
            a = fmaf(eps[j], ld(src + ((size_t)j * Cin + c) * T + t), a);
          v = round_s<S>(fmaxf(a + b1[c], 0.f));
        } else if (MODE == UP) {
          const int th = T / 2, k = t >> 1;
          const S* x = src + (size_t)c * th;
          const float xc = ld(x + k);
          if (t & 1) {
            v = __fadd_rn(__fmul_rn(0.75f, xc), __fmul_rn(0.25f, ld(x + min(k + 1, th - 1))));
          } else {
            v = __fadd_rn(__fmul_rn(0.25f, ld(x + max(k - 1, 0))), __fmul_rn(0.75f, xc));
          }
        } else if (MODE == GATE) {
          const int th = T / 2, k = t >> 1;
          const S* x = src + (size_t)c * th;
          const float g = ep[(size_t)n * Cin + c];
          const float xc = round_s<S>(__fmul_rn(g, ld(x + k)));
          if (t & 1) {
            const float xr = round_s<S>(__fmul_rn(g, ld(x + min(k + 1, th - 1))));
            v = __fadd_rn(__fmul_rn(0.75f, xc), __fmul_rn(0.25f, xr));
          } else {
            const float xl = round_s<S>(__fmul_rn(g, ld(x + max(k - 1, 0))));
            v = __fadd_rn(__fmul_rn(0.25f, xl), __fmul_rn(0.75f, xc));
          }
        } else {
          v = ld(src + (size_t)c * T + t);
        }
      }
      xs[ci][s] = v;
    }
    for (int e = tid; e < 3 * CI_T * CO_T; e += THREADS) {
      const int ci = e % CI_T, co = (e / CI_T) % CO_T, k = e / (CI_T * CO_T);
      float v = 0.f;
      if (co0 + co < Cout && ci0 + ci < Cin)
        v = ld(w + ((size_t)k * Cout + co0 + co) * Cin + ci0 + ci);
      ws[k][ci][co] = v;
    }
    __syncthreads();
#pragma unroll
    for (int ci = 0; ci < CI_T; ++ci) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float xv[4], wv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) xv[i] = xs[ci][tx + 16 * i + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = ws[k][ci][ty + 16 * j];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(wv[j], xv[i], acc[j][i]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + ty + 16 * j;
    if (co >= Cout) continue;
    const float b = bias[co];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + tx + 16 * i;
      if (t < T) st(out + ((size_t)n * Cout + co) * T + t, fmaxf(acc[j][i] + b, 0.f));
    }
  }
}

// conv5 (Cout = 1) + sigmoid(x / 3), float output.
template <typename S>
__global__ void conv5_sigmoid_kernel(const S* __restrict__ in, const S* __restrict__ w,
                                     const float* __restrict__ b5, float* __restrict__ out,
                                     int Cin, int T) {
  __shared__ float ws[3][MAXC5];
  const int n = blockIdx.x;
  const int t = blockIdx.y * blockDim.x + threadIdx.x;
  for (int e = threadIdx.x; e < 3 * Cin; e += blockDim.x) ws[e / Cin][e % Cin] = ld(w + e);
  __syncthreads();
  if (t >= T) return;
  const S* x = in + (size_t)n * Cin * T;
  float acc = 0.f;
  for (int c = 0; c < Cin; ++c) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int tt = t + k - 1;
      if (tt >= 0 && tt < T) acc = fmaf(ws[k][c], ld(x + (size_t)c * T + tt), acc);
    }
  }
  const float v = (acc + b5[0]) / 3.0f;
  out[(size_t)n * T + t] = 1.0f / (1.0f + expf(-v));
}

// The chain from y1 on: conv2 (its input given by MODE2: MIX mixes the basis
// planes `in2` with ep/b1, PLAIN reads the y1 planes `in2` [N, 128, 256]),
// conv3 on up2(h2), conv4, conv5 + sigmoid. h2, h3, h4 are scratch.
template <typename S, int MODE2>
cudaError_t launch_tail(const void* in2, const void* ep, const void* b1, int J, int views,
                        const void* w2, const void* b2, const void* w3, const void* b3,
                        const void* w4, const void* b4, const void* w5, const void* b5, void* h2,
                        void* h3, void* h4, void* out, int N, cudaStream_t stream) {
  const int C1 = 128, C2 = 64, T1 = 256, T2 = 512;
  const dim3 block(THREADS);
  cudaError_t err;

  conv3_relu_kernel<S, MODE2><<<dim3(N, T1 / T_T, C1 / CO_T), block, 0, stream>>>(
      static_cast<const S*>(in2), static_cast<const float*>(ep), static_cast<const float*>(b1), J,
      views, static_cast<const S*>(w2), static_cast<const float*>(b2), static_cast<S*>(h2), C1, C1,
      T1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  conv3_relu_kernel<S, UP><<<dim3(N, T2 / T_T, C2 / CO_T), block, 0, stream>>>(
      static_cast<const S*>(h2), nullptr, nullptr, 0, 1,
      static_cast<const S*>(w3), static_cast<const float*>(b3), static_cast<S*>(h3), C1, C2, T2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  conv3_relu_kernel<S, PLAIN><<<dim3(N, T2 / T_T, C2 / CO_T), block, 0, stream>>>(
      static_cast<const S*>(h3), nullptr, nullptr, 0, 1,
      static_cast<const S*>(w4), static_cast<const float*>(b4), static_cast<S*>(h4), C2, C2, T2);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  conv5_sigmoid_kernel<S><<<dim3(N, T2 / 128), dim3(128), 0, stream>>>(
      static_cast<const S*>(h4), static_cast<const S*>(w5), static_cast<const float*>(b5),
      static_cast<float*>(out), C2, T2);
  return cudaGetLastError();
}

}  // namespace dec
