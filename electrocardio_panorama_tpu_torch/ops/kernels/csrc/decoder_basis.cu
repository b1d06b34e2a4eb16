// Streamed-basis Nef-Net decoder (eval) for Hopper, sm_90a.
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
// conv3 is a kernel-3, padding-1 convolution over time with tap-major weights
// w[3, Cout, Cin] (BatchNorm already folded in); up2 is torch's
// Upsample(x2, linear, align_corners=False) with edge clamp. The output is in
// plain time order: the TPU kernel's [e|o] lane layout, polyphase matrices
// and selector matmuls exist for Mosaic and have no counterpart here.
//
// S is the storage type: float, or __nv_bfloat16 with float accumulation.
// In the bf16 instantiation values round to bf16 where the TPU kernel rounds
// them (y1, the conv2 and conv3 outputs, and conv5's operands, i.e. the conv4
// output); every product and sum is float. The f32 instantiation is plain
// FMA at full float32 (no TF32, no tensor cores).
//
// Bound: about 64 MFLOP per view against a few hundred KB of input per beat,
// so the work is bounded by operations. This first version is direct SIMT
// convolution, one kernel per stage with the intermediate planes in device
// memory (the stage kernels are in decoder_common.cuh, shared with
// decoder_forms.cu); the mix is fused into conv2's input loads so y1 is never
// stored.

#include "decoder_common.cuh"

namespace {

template <typename S>
int launch(const void* U, const void* ep, const void* b1, const void* w2, const void* b2,
           const void* w3, const void* b3, const void* w4, const void* b4, const void* w5,
           const void* b5, void* h2, void* h3, void* h4, void* out, int B, int V, int J,
           void* stream_ptr) {
  if (B <= 0 || V <= 0 || J <= 0 || J > dec::MAXJ) return (int)cudaErrorInvalidValue;
  return (int)dec::launch_tail<S, dec::MIX>(U, ep, b1, J, V, w2, b2, w3, b3, w4, b4, w5, b5, h2, h3,
                                            h4, out, B * V, static_cast<cudaStream_t>(stream_ptr));
}

}  // namespace

// Plain C interface (loaded with ctypes). Pointers are device pointers of
// contiguous tensors: U [B, J, 128, 256] S, ep [B*V, J] f32, b1 [128] f32,
// w2 [3,128,128] S, w3 [3,64,128] S, w4 [3,64,64] S, w5 [3,1,64] S, biases
// f32; scratch h2 [B*V,128,256] S, h3 and h4 [B*V,64,512] S; out [B*V,512]
// f32. Returns 0 or the cudaError_t of the first failed launch.
extern "C" int decoder_basis_f32(const void* U, const void* ep, const void* b1, const void* w2,
                                 const void* b2, const void* w3, const void* b3, const void* w4,
                                 const void* b4, const void* w5, const void* b5, void* h2,
                                 void* h3, void* h4, void* out, int B, int V, int J,
                                 void* stream) {
  return launch<float>(U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5, h2, h3, h4, out, B, V, J,
                       stream);
}

extern "C" int decoder_basis_bf16(const void* U, const void* ep, const void* b1, const void* w2,
                                  const void* b2, const void* w3, const void* b3, const void* w4,
                                  const void* b4, const void* w5, const void* b5, void* h2,
                                  void* h3, void* h4, void* out, int B, int V, int J,
                                  void* stream) {
  return launch<__nv_bfloat16>(U, ep, b1, w2, b2, w3, b3, w4, b4, w5, b5, h2, h3, h4, out, B, V,
                               J, stream);
}

extern "C" const char* decoder_basis_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
