// The stage sequences of the eval decoder forms (see decoder_common.cuh),
// shared by decoder_basis.cu and decoder_forms.cu. S is the storage type:
// float runs the FMA stages (decoder_fma.cuh), __nv_bfloat16 the tensor-core
// stages (decoder_tc.cuh).

#pragma once

#include "decoder_fma.cuh"
#include "decoder_tc.cuh"
#include "stage_timer.cuh"

namespace dec {

// the tail's packed weights (see the wrapper's pack_weights_*), biases and
// scratch planes: h2 [N, 128, 256] and h3 [N, 64, 512] elements of S
struct Tail {
  const void* w2;
  const float* b2;
  const void* w3;     // polyphase conv3, 128 packed output channels (phase, co)
  const float* b3;    // b3 in the packed order, [128]
  const void* cedge;  // [2, 128 n, 128 ci]
  const void* w4;
  const float* b4;
  const void* w5;
  const float* b5;
  void* h2;
  void* h3;
  void* out;  // [N, 512] float
};

// the tail's pointers as parameters of a plain C entry point, and as a Tail
#define DEC_TAIL_PARAMS                                                                            \
  const void *w2, const void *b2, const void *w3, const void *b3, const void *cedge, const void *w4, \
      const void *b4, const void *w5, const void *b5, void *h2, void *h3, void *out
#define DEC_TAIL_VALUE                                                                             \
  dec::Tail {                                                                                      \
    w2, static_cast<const float*>(b2), w3, static_cast<const float*>(b3), cedge, w4,               \
        static_cast<const float*>(b4), w5, static_cast<const float*>(b5), h2, h3, out              \
  }

using timing::StageTimer;

template <typename S, int CIN, int NOUT, int T, int TAPS, int IN, int OUT, bool RELU>
cudaError_t launch_stage(const StageArgs& a, int slices, cudaStream_t stream) {
  if constexpr (sizeof(S) == 4)
    return fma::launch_stage<CIN, NOUT, T, TAPS, IN, OUT, RELU>(a, slices, stream);
  else
    return tc::launch_stage<CIN, NOUT, T, TAPS, IN, OUT, RELU>(a, slices, stream);
}

// dynamic shared memory of a stage's block: stage 0 the gate stage, 1 conv2,
// 2 conv3, 3 conv4 + conv5
template <typename S>
int stage_smem_bytes(int stage) {
  if constexpr (sizeof(S) == 4) {
    const int bytes[4] = {fma::Smem<C1, 1, OUT_PLANE>::BYTES, fma::Smem<C1, 3, OUT_PLANE>::BYTES,
                          fma::Smem<C1, 3, OUT_POLY>::BYTES, fma::Smem<C2, 3, OUT_CONV5>::BYTES};
    return stage >= 0 && stage < 4 ? bytes[stage] : -1;
  } else {
    const int bytes[4] = {tc::Layout<C0, C1, 1, OUT_PLANE>::L::BYTES, tc::Layout<C1, C1, 3, OUT_PLANE>::L::BYTES,
                          tc::Layout<C1, C1, 3, OUT_POLY>::L::BYTES, tc::Layout<C2, C2, 3, OUT_CONV5>::L::BYTES};
    return stage >= 0 && stage < 4 ? bytes[stage] : -1;
  }
}

// conv2 (its loader forms y1 from `in2` as IN2 says), polyphase conv3,
// conv4 + conv5 + sigmoid: three launches (three times in the timer)
template <typename S, int IN2>
cudaError_t launch_tail(const void* in2, const float* ep, const float* b1, int J, int views,
                        const Tail& t, int N, cudaStream_t stream, StageTimer& timer) {
  cudaError_t err;
  StageArgs a{};
  a.N = N;

  a.in = in2, a.ep = ep, a.b_in = b1, a.J = J, a.views = views;
  a.w = t.w2, a.bias = t.b2, a.out = t.h2;
  if ((err = launch_stage<S, C1, C1, T1, 3, IN2, OUT_PLANE, true>(a, 1, stream)) != cudaSuccess) return err;
  timer.mark();

  a.in = t.h2, a.w = t.w3, a.bias = t.b3, a.cedge = t.cedge, a.out = t.h3;
  if ((err = launch_stage<S, C1, C1, T1, 3, IN_PLANE, OUT_POLY, true>(a, 1, stream)) != cudaSuccess) return err;
  timer.mark();

  a.in = t.h3, a.w = t.w4, a.bias = t.b4, a.w5 = t.w5, a.b5 = t.b5, a.out = t.out;
  if ((err = launch_stage<S, C2, C2, T2, 3, IN_PLANE, OUT_CONV5, true>(a, 1, stream)) != cudaSuccess) return err;
  timer.mark();
  return timer.finish();
}

// the gate stage: g [N, 3, 128, 128] = the three taps' channel products of
// gate x latent, one slice of blocks per tap
template <typename S>
cudaError_t launch_gate_stage(const void* latent, const float* gates, const void* w1, void* g, int views,
                              int N, cudaStream_t stream) {
  StageArgs a{};
  a.N = N, a.in = latent, a.ep = gates, a.views = views, a.w = w1, a.out = g;
  return launch_stage<S, C0, C1, T0, 1, IN_GATE, OUT_PLANE, false>(a, 3, stream);
}

}  // namespace dec
