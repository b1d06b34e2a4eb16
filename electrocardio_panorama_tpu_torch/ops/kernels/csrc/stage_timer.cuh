// Times the stages of one kernel chain for a measurement: with a host array
// `ms`, records an event on the stream after every stage and, at the end,
// waits for the stream and writes the stages' milliseconds. Without one (every
// call of the port's paths) it does nothing and the call stays asynchronous.
// Shared by the eval decoder (decoder_chain.cuh) and the encoder backward
// (encoder_bwd.cu).

#pragma once

#include <cuda_runtime.h>

namespace timing {

struct StageTimer {
  static constexpr int MAX_MARKS = 8;
  float* ms;
  cudaStream_t stream;
  cudaEvent_t ev[MAX_MARKS];
  int n = 0;
  StageTimer(float* ms_, cudaStream_t s) : ms(ms_), stream(s) { mark(); }
  void mark() {
    if (!ms || n == MAX_MARKS) return;
    cudaEventCreate(&ev[n]);
    cudaEventRecord(ev[n++], stream);
  }
  cudaError_t finish() {
    if (!ms) return cudaSuccess;
    const cudaError_t err = cudaStreamSynchronize(stream);
    for (int i = 0; i + 1 < n; ++i) cudaEventElapsedTime(ms + i, ev[i], ev[i + 1]);
    for (int i = 0; i < n; ++i) cudaEventDestroy(ev[i]);
    n = 0;
    return err;
  }
};

}  // namespace timing
