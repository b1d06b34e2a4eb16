// Fused train-mode Nef-Net decoder, forward, for Hopper, sm_90a.
//
// Replaces the TPU kernel electrocardio_panorama_tpu/ops/pallas/decoder_train.py
// ::_train_fwd_kernel (via _fwd_call): the three grouped decodes of a train
// step with BatchNorm on per-group batch statistics, returning the
// post-sigmoid output and every BN layer's biased batch moments. The chain,
// its rounding points and its bound are described in decoder_train_common.cuh.

#include "decoder_train_common.cuh"

// Plain C interface (loaded with ctypes). `ptrs` is a host array of
// dtr::NPTR device pointers in the enum order of decoder_train_common.cuh:
// x [G, 256, nb*128] S; w1..w5 [3, Cout, Cin] S; biases and BN affines f32;
// scratch a1, a2 [G*nb, 128, 256] and a3, a4 [G*nb, 64, 512] f32, h1, h2, h3 in
// S and h4 f32 of the same shapes; outputs out [G, nb, 512] f32 and mean, var
// [G, 4, 128] f32, zero-filled by the caller (channels 64..127 of layers 3 and
// 4 stay zero). The backward's entries of the table are not read. Returns 0
// or the cudaError_t of the first failed launch.
extern "C" int decoder_train_fwd_f32(void* const* ptrs, int G, int nb, void* stream) {
  if (G <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  return dtr::forward_chain<float>(ptrs, G, nb, static_cast<cudaStream_t>(stream));
}

extern "C" int decoder_train_fwd_bf16(void* const* ptrs, int G, int nb, void* stream) {
  if (G <= 0 || nb <= 0) return (int)cudaErrorInvalidValue;
  return dtr::forward_chain<__nv_bfloat16>(ptrs, G, nb, static_cast<cudaStream_t>(stream));
}

extern "C" int decoder_train_fwd_nptr() { return dtr::NPTR; }

extern "C" const char* decoder_train_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
