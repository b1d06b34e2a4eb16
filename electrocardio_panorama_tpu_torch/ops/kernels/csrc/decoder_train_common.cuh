// Shared pieces of the fused train-mode Nef-Net decoder kernels (forward in
// decoder_train_fwd.cu, backward in decoder_train_bwd.cu) for Hopper, sm_90a.
//
// Replaces the TPU kernels electrocardio_panorama_tpu/ops/pallas/decoder_train.py
// ::_train_fwd_kernel and ::_train_bwd_kernel. Over G groups of nb samples
// (the three decodes of a train step), with BatchNorm on each group's own
// batch statistics:
//
//   a1 = conv3(up2(x); w1) + b1          h1 = round_s(relu(bn1(a1)))   [128, 256]
//   a2 = conv3(h1; w2) + b2              h2 = round_s(relu(bn2(a2)))   [128, 256]
//   a3 = conv3(up2(h2); w3) + b3         h3 = round_s(relu(bn3(a3)))   [ 64, 512]
//   a4 = conv3(h3; w4) + b4              h4 = relu(bn4(a4))            [ 64, 512]
//   out = sigmoid((conv3(round_s(h4); w5) + b5) / 3)                   [512]
//
// conv3 is a kernel-3, padding-1 convolution over time with tap-major weights
// w[3, Cout, Cin]; up2 is torch's Upsample(x2, linear, align_corners=False)
// with edge clamp, per sample. x arrives channel-major, [G, 256, nb*128], as
// the TPU kernel takes it; every other plane is [G*nb, C, T]. Everything is in
// plain time order: the TPU kernel's upsample-shift matmuls, lane shifts and
// masks exist for Mosaic and have no counterpart here.
//
// S is the storage type of x, the weights and h1..h3: float, or __nv_bfloat16.
// Every product and sum is float, the pre-BN planes a1..a4, h4, the moments and
// the output are float, and BatchNorm runs in float. In the backward a
// gradient is float and rounds to S only as a product's operand.
//
// BatchNorm's moments per (group, channel) come from a two-pass reduction
// (the mean, then the mean of squared deviations): more accurate than the TPU
// kernel's E[a^2] - mean^2 and equal to it within rounding. One block reduces
// one (group, channel) in a fixed order, so a repeat launch gives the same
// bits.
//
// Bound. The forward's four convs are 113.4 MFLOP per sample at output
// resolution; at 3 groups of 32 that is 10.9 GFLOP, 0.163 ms at the float32
// FMA peak of an H100, against the 113 MB (float32) or 88 MB (bfloat16)
// that it reads and writes: x, the weights, the planes it keeps for the
// backward (a1..a4 and h4 float32, h1..h3 in S), out and the moments. So
// float32 is bound by operations; bfloat16, whose upsampled convs run at
// input resolution on tensor cores (7.2 GFLOP, 0.007 ms at the bf16 peak),
// by bytes (0.026 ms at 3.35 TB/s). It runs one kernel per stage with every
// plane in device memory: a conv stage writes the pre-BN plane, a reduction
// takes the moments, and an elementwise stage normalises, applies the affine
// and the relu. The conv stages run on the FMA engine of decoder_train_fma.cuh
// in float32 and on the tensor-core engine of decoder_train_tc.cuh in
// bfloat16; the moments, the normalisation and conv5 are SIMT in both. The
// backward reads those planes; its products run on the same two engines.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dtr {

constexpr int C0 = 256, C1 = 128, C2 = 64;   // channels: x, after conv1/conv2, after conv3/conv4
constexpr int T0 = 128, T1 = 256, T2 = 512;  // time steps: x, after the first up2, after the second
constexpr int STAT_C = 128;                  // moments are padded to 128 channels per layer
constexpr float EPS = 1e-5f;

// The ctypes wrapper passes one host array of device pointers in this order
// (ops/kernels/decoder_train.py PTR_NAMES).
enum Ptr {
  X,
  W1, B1, G1, O1, W2, B2, G2, O2, W3, B3, G3, O3, W4, B4, G4, O4, W5, B5,
  P_A1, P_H1, P_A2, P_H2, P_A3, P_H3, P_A4, P_H4, OUT, MEAN, VAR,
  DOUT, DX,
  GW1, GB1, GG1, GO1, GW2, GB2, GG2, GO2, GW3, GB3, GG3, GO3, GW4, GB4, GG4, GO4, GW5, GB5,
  NPTR
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename S> __device__ __forceinline__ float round_s(float v);
template <> __device__ __forceinline__ float round_s<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_s<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A [G, nb, C, T] tensor in any order of its first three dimensions, time
// contiguous: the row of sample n = g*nb + b and channel c.
template <typename TI>
struct View {
  const TI* p;
  long long sG, sB, sC;
  int nb;
  __device__ __forceinline__ const TI* row(int n, int c) const {
    return p + (n / nb) * sG + (n % nb) * sB + c * sC;
  }
};

// [G*nb, C, T]
template <typename TI>
View<TI> planes(const void* p, int nb, int C, int T) {
  return View<TI>{static_cast<const TI*>(p), (long long)nb * C * T, (long long)C * T, T, nb};
}

// [G, C, nb*T], the layout of x and dx
template <typename TI>
View<TI> grouped(const void* p, int nb, int C, int T) {
  return View<TI>{static_cast<const TI*>(p), (long long)C * nb * T, T, (long long)nb * T, nb};
}

// up2(round_s(x[0..th)))[t]
template <typename S, typename TI>
__device__ __forceinline__ float up2_at(const TI* x, int t, int th) {
  const int k = t >> 1;
  const float xc = round_s<S>(ld(x + k));
  if (t & 1)
    return __fadd_rn(__fmul_rn(0.75f, xc), __fmul_rn(0.25f, round_s<S>(ld(x + min(k + 1, th - 1)))));
  return __fadd_rn(__fmul_rn(0.25f, round_s<S>(ld(x + max(k - 1, 0)))), __fmul_rn(0.75f, xc));
}

// Fixed-order tree sum of the block's partials in shared memory (blockDim.x
// a power of two, at most 256).
__device__ __forceinline__ float block_sum(float v, float* red) {
  __syncthreads();  // red may still be read from a previous sum
  red[threadIdx.x] = v;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

// The backward engines' reductions of their partials (decoder_train_fma.cuh,
// decoder_train_tc.cuh).
// Adds the ranges' partials in order and writes the gradient tap-major:
// (o, i, k) at out[(k*Cout + o)*Cin + i].
__global__ void dw_reduce_kernel(const float* __restrict__ part, int ranges, int Cout, int Cin,
                                 float* __restrict__ out) {
  const int n = Cout * Cin * 3;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int z = 0; z < ranges; ++z) s += part[(size_t)z * n + e];
  const int R = Cin * 3;
  const int o = e / R, r = e - o * R;
  const int i = r / 3, k = r - 3 * i;
  out[((size_t)k * Cout + o) * Cin + i] = s;
}

// bias[o] = the sum of the partials of rows (phase, o) over ranges and
// phases: one warp per o, lane l adding ranges l, l + 32, ... in order, then
// a fixed shuffle tree.
__global__ void bias_reduce_kernel(const float* __restrict__ part, int ranges, int phases, int Cout,
                                   float* __restrict__ out) {
  const int o = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (o >= Cout) return;  // whole warps
  float s = 0.f;
  for (int z = lane; z < ranges; z += 32)
    for (int p = 0; p < phases; ++p) s += part[(z * phases + p) * Cout + o];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[o] = s;
}

__device__ __forceinline__ float bn_inv(float var) { return 1.0f / sqrtf(var + EPS); }

inline int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

#define DTR_TRY(expr)                                  \
  do {                                                 \
    cudaError_t _e = (expr);                           \
    if (_e != cudaSuccess) return (int)_e;             \
  } while (0)

#define DTR_RC(expr)                   \
  do {                                 \
    int _rc = (expr);                  \
    if (_rc != 0) return _rc;          \
  } while (0)

}  // namespace dtr
