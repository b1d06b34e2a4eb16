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
// then the shared chain (conv2 .. conv5, sigmoid). As in the TPU kernel,
// conv1's channel products are taken before the upsample, at 128 steps: the
// gate stage forms gate x latent while it loads its input and writes the
// three taps' products g_k = W1_k (gate x latent), and conv2's loader forms
// y1 = relu(sum_k up2(g_k)[t + k - 1] + b1) from them, which halves conv1's
// operations. In bfloat16, latent and gate are rounded before their product,
// and the product and g_k round again; the upsample and every sum are float.
//
// decoder_y1 replaces ::_decoder_kernel_ppb: the shared chain on y1 planes
// [B*V, 128, 256] that the caller mixed outside (basis_y1), the audit form
// that splits the basis mix from the tail.
//
// Bound: 113.4 MFLOP per view (gates, counted with conv1 at the high rate)
// and 63.1 MFLOP per view (y1) against at most 128 KB of input per view, so
// both are bound by operations. Four and three launches (decoder_chain.cuh);
// in bfloat16 the products run on the tensor cores (decoder_tc.cuh), in
// float32 as FMA (decoder_fma.cuh).

#include "decoder_chain.cuh"

namespace {

template <typename S>
int launch_gates(const void* latent, const void* gates, const void* w1, const void* b1, void* g,
                 const dec::Tail& t, int B, int V, void* stage_ms, void* stream_ptr) {
  if (B <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  dec::StageTimer timer(static_cast<float*>(stage_ms), stream);
  cudaError_t err = dec::launch_gate_stage<S>(latent, static_cast<const float*>(gates), w1, g, V, B * V, stream);
  if (err != cudaSuccess) return (int)err;
  timer.mark();
  return (int)dec::launch_tail<S, dec::IN_G3>(g, nullptr, static_cast<const float*>(b1), 0, 1, t, B * V, stream,
                                              timer);
}

template <typename S>
int launch_y1(const void* y1, const dec::Tail& t, int N, void* stage_ms, void* stream_ptr) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  dec::StageTimer timer(static_cast<float*>(stage_ms), stream);
  return (int)dec::launch_tail<S, dec::IN_Y1>(y1, nullptr, nullptr, 0, 1, t, N, stream, timer);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors in the wrapper's packed layouts: latent [B, 256, 128]
// float, or [B, 32, 128, 8] bfloat16; gates [B*V, 256] f32 (already rounded to
// S's values); w1 packed, b1 [128] f32; g [B*V, 3, 128, 128] elements of S,
// scratch; y1 [B*V, 128, 256] S; the tail's weights, biases and scratch as in
// dec::Tail; out [B*V, 512] f32. stage_ms: null, or a host array of 4 (gates)
// or 3 (y1) floats that receives the stages' times (the call then waits for
// the stream). Returns 0 or the cudaError_t of the first failed launch.

extern "C" int decoder_gates_f32(const void* latent, const void* gates, const void* w1, const void* b1,
                                 void* g, DEC_TAIL_PARAMS, int B, int V, void* stage_ms, void* stream) {
  return launch_gates<float>(latent, gates, w1, b1, g, DEC_TAIL_VALUE, B, V, stage_ms, stream);
}

extern "C" int decoder_gates_bf16(const void* latent, const void* gates, const void* w1, const void* b1,
                                  void* g, DEC_TAIL_PARAMS, int B, int V, void* stage_ms, void* stream) {
  return launch_gates<__nv_bfloat16>(latent, gates, w1, b1, g, DEC_TAIL_VALUE, B, V, stage_ms, stream);
}

extern "C" int decoder_y1_f32(const void* y1, DEC_TAIL_PARAMS, int N, void* stage_ms, void* stream) {
  return launch_y1<float>(y1, DEC_TAIL_VALUE, N, stage_ms, stream);
}

extern "C" int decoder_y1_bf16(const void* y1, DEC_TAIL_PARAMS, int N, void* stage_ms, void* stream) {
  return launch_y1<__nv_bfloat16>(y1, DEC_TAIL_VALUE, N, stage_ms, stream);
}

// dynamic shared memory in bytes of one block of a stage (0 the gate stage,
// 1 conv2, 2 conv3, 3 conv4 + conv5), for reports; -1 for no such stage
extern "C" int decoder_stage_smem_bytes(int bf16, int stage) {
  return bf16 ? dec::stage_smem_bytes<__nv_bfloat16>(stage) : dec::stage_smem_bytes<float>(stage);
}

extern "C" const char* decoder_forms_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
