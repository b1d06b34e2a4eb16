// Shared parts of the eval Nef-Net decoder kernels for Hopper, sm_90a: the
// streamed-basis form (decoder_basis.cu) and the gate-input and y1 forms
// (decoder_forms.cu). Together they replace the TPU kernels of
// electrocardio_panorama_tpu/ops/pallas/decoder_fused.py (_decoder_kernel_ppu,
// _decoder_kernel_pp, _decoder_kernel, _decoder_kernel_ppb and their shared
// tail _pp_tail). All forms end in the same chain
//
//   h2     = relu(conv3(y1; w2) + b2)                       [128, 256]
//   h3     = relu(conv3(up2(h2); w3) + b3)                  [ 64, 512]
//   h4     = relu(conv3(h3; w4) + b4)                       [ 64, 512]
//   out[v] = sigmoid((conv3(h4; w5) + b5) / 3)              [512]
//
// and differ in how y1 [128, 256] comes about. conv3 is a kernel-3, padding-1
// convolution over time with BatchNorm folded in; up2 is torch's
// Upsample(x2, linear, align_corners=False) with edge clamp.
//
// The chain runs as stages, each one convolution as a matrix product over
// (time, input channel) x (input channel, output channel) per tap:
//
//   gate stage (gate form only): g_k = W1_k (gate x latent), the three taps'
//       channel products at the low rate, 128 steps; the next stage's loader
//       forms y1 = relu(sum_k up2(g_k)[t + k - 1] + b1) from them
//   conv2:  its loader forms y1 (basis mix | from g | given planes)
//   conv3:  the x2 upsample is folded into polyphase weights: an even and an
//       odd 3-tap product over h2 itself, interleaved on store, plus a
//       correction on the two edge columns for the upsample's clamp
//   conv4 + conv5: conv5 (one output channel) and the sigmoid run in conv4's
//       epilogue, so h4 never leaves the chip
//
// Bound: 63 to 113 MFLOP per view against at most 128 KB of input per view,
// so every form is bound by operations. The bfloat16 instantiation
// (decoder_tc.cuh) runs the products on the tensor cores (wgmma); the float32
// instantiation (decoder_fma.cuh) is plain FMA at full float32 (no TF32, no
// tensor cores). Both hold the stage's weights or stream them through shared
// memory, form the input tile of the next step while the current one is in
// the arithmetic units, and write h2 and h3 once and read them once.
//
// The layouts of U, the latent, the weights and the scratch planes are the
// wrapper's (ops/kernels/decoder_fused.py: pack_chunked, pack_weights_*).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dec {

constexpr int MAXJ = 32;  // basis planes; 13 at theta_L=1
constexpr int C0 = 256;   // latent channels
constexpr int C1 = 128;   // y1 / h2 channels
constexpr int C2 = 64;    // h3 / h4 channels
constexpr int T0 = 128;   // latent steps
constexpr int T1 = 256;   // y1 / h2 steps
constexpr int T2 = 512;   // h3 / h4 / output steps

// how a stage's loader forms its input tile
enum In {
  IN_PLANE = 0,  // a scratch plane of the previous stage, copied as it is
  IN_MIX = 1,    // relu(sum_j ep[n, j] * U[n / views, j] + b1), rounded
  IN_G3 = 2,     // relu(sum_k up2(g[n, k])[t + k - 1] + b1), rounded
  IN_Y1 = 3,     // the caller's y1 planes [N, 128, 256]
  IN_GATE = 4,   // round(gate[n, c] * latent[n / views, c]), no upsample
};

// what a stage's epilogue does with the products
enum Out {
  OUT_PLANE = 0,  // (+ bias, relu,) round, store as the next stage's plane
  OUT_POLY = 1,   // edge corrections, + bias, relu, round, interleave the phases
  OUT_CONV5 = 2,  // + bias, relu, round, conv5 + sigmoid(x / 3), float output
};

struct StageArgs {
  const void* in;     // the loader's source (see In)
  const float* ep;    // IN_MIX: coefficients [N, J]; IN_GATE: gates [N, 256]
  const float* b_in;  // IN_MIX / IN_G3: b1 [128]
  int J, views;
  const void* w;      // packed weights of the stage
  const float* bias;  // [NOUT] in the order of the packed output channels
  const void* cedge;  // OUT_POLY: edge corrections [2, 128 n, 128 ci]
  const void* w5;     // OUT_CONV5: [3, 64]
  const float* b5;
  void* out;
  int N;              // views in all
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy into shared memory; zero fill where !valid (src
// must still be an address inside the allocation)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid = true) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ float sigmoid_third(float v) { return 1.0f / (1.0f + expf(-v / 3.0f)); }

// up2 of a 128-step row at position p of 256, from the two source steps
__device__ __forceinline__ void up2_taps(int p, int& s, int& s2) {
  s = p >> 1;
  s2 = (p & 1) ? min(s + 1, T0 - 1) : max(s - 1, 0);
}

inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace dec
