// Gate-input and y1 forms of the eval Nef-Net decoder for Hopper, sm_90a.
//
// decoder_gates replaces the TPU kernels
// electrocardio_panorama_tpu/ops/pallas/decoder_fused.py::_decoder_kernel_pp
// (the polyphase gate kernel, float32 and bfloat16) and ::_decoder_kernel (the
// float32 dense-upsample form with selector-matmul gates). The two compute
// the same function of the same inputs and differ only in their Mosaic
// layouts, so here they are one kernel chain, and the second is its float32
// instantiation. Per beat b and view v:
//
//   y1[v]  = relu(conv3(up2(gate[v] x latent[b]); w1) + b1)  [128, 256]
//
// then the shared chain of decoder_common.cuh (conv2 .. conv5, sigmoid).
// conv1's stage forms gate x latent and the x2 upsample while it loads its
// input (256 channels of 128 steps per beat), so only y1 goes to device
// memory. In bfloat16, latent and gate are rounded before their product and
// the product rounds again, as in the TPU kernel; the upsample and every sum
// are float.
//
// decoder_y1 replaces ::_decoder_kernel_ppb: the shared chain on y1 planes
// [B*V, 128, 256] that the caller mixed outside (basis_y1), the audit form
// that splits the basis mix from the tail.
//
// Bound: 113.4 MFLOP per view (gates) and 63.1 MFLOP per view (y1) against
// at most 128 KB of input per view, so both are bound by operations. Direct
// SIMT stages with the planes in device memory, as decoder_basis.cu.

#include "decoder_common.cuh"

namespace {

template <typename S>
int launch_gates(const void* latent, const void* gates, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* w3, const void* b3, const void* w4,
                 const void* b4, const void* w5, const void* b5, void* y1, void* h2, void* h3,
                 void* h4, void* out, int B, int V, void* stream_ptr) {
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int N = B * V, C0 = 256, C1 = 128, T1 = 256;
  dec::conv3_relu_kernel<S, dec::GATE>
      <<<dim3(N, T1 / dec::T_T, C1 / dec::CO_T), dim3(dec::THREADS), 0, stream>>>(
          static_cast<const S*>(latent), static_cast<const float*>(gates), nullptr, 0, V,
          static_cast<const S*>(w1), static_cast<const float*>(b1), static_cast<S*>(y1), C0, C1, T1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)dec::launch_tail<S, dec::PLAIN>(y1, nullptr, nullptr, 0, 1, w2, b2, w3, b3, w4, b4, w5,
                                              b5, h2, h3, h4, out, N, stream);
}

template <typename S>
int launch_y1(const void* y1, const void* w2, const void* b2, const void* w3, const void* b3,
              const void* w4, const void* b4, const void* w5, const void* b5, void* h2, void* h3,
              void* h4, void* out, int N, void* stream_ptr) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  return (int)dec::launch_tail<S, dec::PLAIN>(y1, nullptr, nullptr, 0, 1, w2, b2, w3, b3, w4, b4, w5,
                                              b5, h2, h3, h4, out, N,
                                              static_cast<cudaStream_t>(stream_ptr));
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: latent [B, 256, 128] S, gates [B*V, 256] f32 (already
// rounded to S's values), w1 [3,128,256] S, w2 [3,128,128] S, w3 [3,64,128] S,
// w4 [3,64,64] S, w5 [3,1,64] S, biases f32; y1 and h2 [B*V,128,256] S, h3 and
// h4 [B*V,64,512] S (y1 an input of decoder_y1, scratch of decoder_gates; the
// others scratch); out [B*V,512] f32. Returns 0 or the cudaError_t of the
// first failed launch.
extern "C" int decoder_gates_f32(const void* latent, const void* gates, const void* w1,
                                 const void* b1, const void* w2, const void* b2, const void* w3,
                                 const void* b3, const void* w4, const void* b4, const void* w5,
                                 const void* b5, void* y1, void* h2, void* h3, void* h4, void* out,
                                 int B, int V, void* stream) {
  return launch_gates<float>(latent, gates, w1, b1, w2, b2, w3, b3, w4, b4, w5, b5, y1, h2, h3, h4,
                             out, B, V, stream);
}

extern "C" int decoder_gates_bf16(const void* latent, const void* gates, const void* w1,
                                  const void* b1, const void* w2, const void* b2, const void* w3,
                                  const void* b3, const void* w4, const void* b4, const void* w5,
                                  const void* b5, void* y1, void* h2, void* h3, void* h4, void* out,
                                  int B, int V, void* stream) {
  return launch_gates<__nv_bfloat16>(latent, gates, w1, b1, w2, b2, w3, b3, w4, b4, w5, b5, y1, h2,
                                     h3, h4, out, B, V, stream);
}

extern "C" int decoder_y1_f32(const void* y1, const void* w2, const void* b2, const void* w3,
                              const void* b3, const void* w4, const void* b4, const void* w5,
                              const void* b5, void* h2, void* h3, void* h4, void* out, int N,
                              void* stream) {
  return launch_y1<float>(y1, w2, b2, w3, b3, w4, b4, w5, b5, h2, h3, h4, out, N, stream);
}

extern "C" int decoder_y1_bf16(const void* y1, const void* w2, const void* b2, const void* w3,
                               const void* b3, const void* w4, const void* b4, const void* w5,
                               const void* b5, void* h2, void* h3, void* h4, void* out, int N,
                               void* stream) {
  return launch_y1<__nv_bfloat16>(y1, w2, b2, w3, b3, w4, b4, w5, b5, h2, h3, h4, out, N, stream);
}

extern "C" const char* decoder_forms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
