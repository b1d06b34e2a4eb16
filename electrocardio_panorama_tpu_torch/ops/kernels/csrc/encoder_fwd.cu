// Fused Nef-Net encoder, forward (kernel A2) for Hopper, sm_90a.
//
// Replaces the TPU kernel electrocardio_panorama_tpu/ops/pallas/encoder_fused.py
// ::_fwd_kernel (via _fwd_call), the forward of encode_fused_train and of
// encode_fused_eval:
//
//   conv1(k15, s2) -> relu -> maxpool(k3, s2) -> 3x BasicBlock(k7) + dropout
//   -> x gate1 -> w_conv(k3) -> split z1/z2 -> z1_conv / z2_conv1
//   -> roi_align (closed form) -> z2_conv2.{0, 1 (convT k2 s2), 2}
//
// emitting z1 [B, 128L, 128] and the pre-reverse z2 grid [B, 896L, 32]
// (torch row-major [B, 128L, 7, 32]). Every intermediate plane goes through
// device memory; the caller keeps the ones its backward reads (the
// encoder_ckpt modes). The stage sequence and kernels are in
// encoder_common.cuh; design and bound are described there.

#include "encoder_common.cuh"

// Plain C interface (loaded with ctypes). `ptrs` is a host array of NPTR
// device pointers in the encoder_common.cuh enum order; inputs X, GATE, RAMP,
// the weights and every P_* plane must be set (the masks M6, MC20, MC22 and
// the P_*M dropout planes only when train is 1). `workspace` holds
// encoder_fwd_workspace_floats_f32(L) floats (encoder_fwd_workspace_floats_bf16
// for encoder_fwd_bf16): the engine's packed weights. Returns 0 or the
// cudaError_t of the first failed launch.
extern "C" long long encoder_fwd_workspace_floats_f32(int L) { return enc::pack_floats<float>(L); }
extern "C" long long encoder_fwd_workspace_floats_bf16(int L) { return enc::pack_floats<__nv_bfloat16>(L); }

extern "C" int encoder_fwd_f32(void* const* ptrs, int B, int L, int train, void* workspace, void* stream) {
  enc::error_site() = enc::ErrorSite{};
  if (B <= 0 || L <= 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
  return enc::forward_chain<float>(ptrs, B, L, 2, train, static_cast<cudaStream_t>(stream), workspace);
}

extern "C" int encoder_fwd_bf16(void* const* ptrs, int B, int L, int train, void* workspace, void* stream) {
  enc::error_site() = enc::ErrorSite{};
  if (B <= 0 || L <= 0 || workspace == nullptr) return (int)cudaErrorInvalidValue;
  return enc::forward_chain<__nv_bfloat16>(ptrs, B, L, 2, train, static_cast<cudaStream_t>(stream), workspace);
}

extern "C" int encoder_fwd_nptr() { return enc::NPTR; }

extern "C" const char* encoder_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" const char* encoder_fwd_error_file() { return enc::error_site().file; }
extern "C" int encoder_fwd_error_line() { return enc::error_site().line; }
