// Streamed-basis Nef-Net decoder (eval) for Hopper, sm_90a: the panorama
// render hot path.
//
// Replaces the TPU kernel electrocardio_panorama_tpu/ops/pallas/decoder_fused.py
// ::_decoder_kernel_ppu together with its tail _pp_tail. Per beat b and view v:
//
//   y1[v]  = relu(sum_j ep[v, j] * U[b, j] + b1)            [128, 256]
//   h2     = relu(conv3(y1; w2) + b2)                       [128, 256]
//   h3     = relu(conv3(up2(h2); w3) + b3)                  [ 64, 512]
//   h4     = relu(conv3(h3; w4) + b4)                       [ 64, 512]
//   out[v] = sigmoid((conv3(h4; w5) + b5) / 3)              [512]
//
// S is the storage type: float, or __nv_bfloat16 with float accumulation,
// rounding where the TPU kernel rounds (y1, the conv2 and conv3 outputs with
// the upsample folded into conv3's weights, and the conv4 output as conv5's
// operand).
//
// Bound: about 64 MFLOP per view against a few hundred KB of input per beat,
// so the work is bounded by operations. Three launches (decoder_chain.cuh):
// conv2 with the mix in its loader, formed once per view and time tile for
// all 128 output channels from U, which stays in L2, so y1 is never stored;
// the polyphase conv3; conv4 with conv5 and the sigmoid in its epilogue. In
// bfloat16 the products run on the tensor cores (decoder_tc.cuh), in float32
// as FMA (decoder_fma.cuh).

#include "decoder_chain.cuh"

namespace {

template <typename S>
int launch(const void* U, const void* ep, const void* b1, const dec::Tail& t, int B, int V, int J,
           void* stage_ms, void* stream_ptr) {
  if (B <= 0 || V <= 0 || J <= 0 || J > dec::MAXJ) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  dec::StageTimer timer(static_cast<float*>(stage_ms), stream);
  return (int)dec::launch_tail<S, dec::IN_MIX>(U, static_cast<const float*>(ep), static_cast<const float*>(b1),
                                               J, V, t, B * V, stream, timer);
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors in the wrapper's packed layouts: U [B, J, 128, 256]
// float, or [B, 16, J, 256, 8] bfloat16; ep [B*V, J] f32; b1 [128] f32; the
// tail's weights, biases and scratch as in dec::Tail; out [B*V, 512] f32.
// stage_ms: null, or a host array of 3 floats that receives the stages'
// times (the call then waits for the stream). Returns 0 or the cudaError_t of
// the first failed launch.

extern "C" int decoder_basis_f32(const void* U, const void* ep, const void* b1, DEC_TAIL_PARAMS, int B,
                                 int V, int J, void* stage_ms, void* stream) {
  return launch<float>(U, ep, b1, DEC_TAIL_VALUE, B, V, J, stage_ms, stream);
}

extern "C" int decoder_basis_bf16(const void* U, const void* ep, const void* b1, DEC_TAIL_PARAMS, int B,
                                  int V, int J, void* stage_ms, void* stream) {
  return launch<__nv_bfloat16>(U, ep, b1, DEC_TAIL_VALUE, B, V, J, stage_ms, stream);
}

extern "C" const char* decoder_basis_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
