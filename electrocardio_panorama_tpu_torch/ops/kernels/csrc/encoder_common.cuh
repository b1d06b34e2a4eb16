// Shared pieces of the fused Nef-Net encoder kernels (A2 forward in
// encoder_fwd.cu, A3 backward in encoder_bwd.cu) for Hopper, sm_90a.
//
// Replaces the TPU kernels electrocardio_panorama_tpu/ops/pallas/encoder_fused.py
// ::_fwd_kernel and ::_bwd_kernel. They compute the same function in the
// model layout [B, C, T]; the TPU kernels' lane planes, polyphase conv1 and
// selector matmuls exist for Mosaic and have no counterpart here.
//
// Every convolution of the chain (grouped, any kernel size and stride, the
// k2s2 transposed conv as two 1x1 convs, and every data gradient as a conv
// with transposed, flipped weights) runs through one implicit-GEMM engine
// with a fused epilogue (`conv_store`): in bfloat16 the tensor-core engine
// of encoder_tc.cuh, in float32 the register-tiled FMA engine of
// encoder_fma.cuh, and conv1 (one input channel per group) in both on the
// SIMT `conv_kernel` (launch_conv chooses). Storage type S is float or
// __nv_bfloat16; every product and sum is float. Values round to S where the
// TPU kernel rounds them (`_stages`' .astype(sd) points); in the backward,
// gradients are float and round to S only as GEMM operands, as the TPU
// kernel's dot operands do.
//
// Bound: about 29 GFLOP forward and 59 GFLOP backward at B=32, L=3 against
// tens of MB of planes, so both are bound by operations. Every intermediate
// plane goes through device memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef ENC_LAUNCH
#define ENC_LAUNCH(kern, grid, block, stream, ...) kern<<<(grid), (block), 0, (stream)>>>(__VA_ARGS__)
#endif

namespace enc {

constexpr int FEAT = 128;   // latent channels per lead, and the tower's time length
constexpr int SEQ = 512;    // input samples
constexpr int SEGS = 7;     // ROI segments
constexpr int ALIGN = 16;   // roi_align samples per segment
constexpr int TP = 64;      // output positions (sample, time) per block
constexpr int TC = 64;      // output channels per block
constexpr int TR = 64;      // reduction rows (input channel, tap) staged per step
constexpr int THREADS = 256;

// ------------------------------------------------------------- pointer table
// The ctypes wrapper passes one host array of device pointers in this order
// (ops/kernels/encoder_fused.py PTR_NAMES). Weights keep the torch layouts of
// the Nef-Net checkpoint.
enum Ptr {
  X, GATE, RAMP, M6, MC20, MC22,
  W_C1, W_L0C1, W_L0C2, W_L1C1, W_L1C2, W_L2C1, W_L2C2, W_WC1, W_WC2,
  W_Z1W1, W_Z1W2, W_Z1WR, B_Z1, W_Z2W1, W_Z2W2, W_Z2WR, B_Z2,
  W_C20W1, W_C20W2, W_T, B_T, W_C22W1, W_C22W2, W_C22WR, B_C22,
  P_C, P_H0, P_R1_0, P_R1M_0, P_H1, P_R1_1, P_R1M_1, P_H2, P_R1_2, P_R1M_2, P_H3,
  P_HG, P_WR1, P_WR1M, P_HW, P_ZR11, P_ZR1M1, P_Z1F, P_ZR12, P_ZR1M2, P_Z2F,
  P_A, P_C1, P_C1M, P_HC, P_HT, P_C2, P_C2M, P_Z2G,
  D_Z1, D_Z2G, G_GATE,
  G_C1, G_L0C1, G_L0C2, G_L1C1, G_L1C2, G_L2C1, G_L2C2, G_WC1, G_WC2,
  G_Z1W1, G_Z1W2, G_Z1WR, G_BZ1, G_Z2W1, G_Z2W2, G_Z2WR, G_BZ2,
  G_C20W1, G_C20W2, G_T, G_BT, G_C22W1, G_C22W2, G_C22WR, G_BC22,
  NPTR
};

// Where the first failed launch of the last call was made, for the wrapper's
// error message (encoder_*_error_file / _error_line). The entry points reset
// it when a call begins.
struct ErrorSite {
  const char* file = "";
  int line = 0;
};
inline ErrorSite& error_site() {
  static ErrorSite site;
  return site;
}
// the innermost site of a failure: the first recorded since the call began
inline cudaError_t failed_at(cudaError_t e, const char* file, int line) {
  if (e != cudaSuccess && error_site().line == 0) error_site() = ErrorSite{file, line};
  return e;
}

// return the error of a failed launch (from a function returning int, or,
// ENC_CHECK, cudaError_t), recording where it failed
#define ENC_TRY(expr)                                                      \
  do {                                                                     \
    cudaError_t _e = enc::failed_at((expr), __FILE__, __LINE__);           \
    if (_e != cudaSuccess) return (int)_e;                                 \
  } while (0)
#define ENC_CHECK(expr)                                                    \
  do {                                                                     \
    cudaError_t _e = enc::failed_at((expr), __FILE__, __LINE__);           \
    if (_e != cudaSuccess) return _e;                                      \
  } while (0)

// ------------------------------------------------------------------ scalars
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename S> __device__ __forceinline__ float round_s(float v);
template <> __device__ __forceinline__ float round_s<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_s<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ------------------------------------------------------------- conv kernel
// out[n, oc(g, o), t*ots + oto] = epilogue(sum over rows (i, k) of
//     W(g, o, i, k) * round_s(x[n, xc(g, i), t*stride + k - pad]))
// over output positions p = n*Tout + t, with channel maps
// xc(g, i) = g*x_gs + x_off + i and oc(g, o) = g*o_gs + o_off + o, and
// W(g, o, i, k) = w[g*wsG + o*wsO + i*wsI + k*wsK] (strides may be negative:
// a data gradient reads the forward weights transposed and flipped).
template <typename S, typename TI>
struct Operand {
  const TI* x;
  int xC, xT, x_gs, x_off;   // channels and time length of x; channel map
  const S* w;
  long long wsG, wsO, wsI, wsK;
  int cig, K, stride, pad;   // input channels per group, taps, stride, padding
};

template <typename S, typename TI, typename TO>
struct ConvArgs {
  Operand<S, TI> a;          // the conv
  Operand<S, TI> b;          // optional second term summed before the epilogue (b.x null: none)
  int N, Tout, cog;          // batch, output positions per sample, output channels per group
  TO* out;
  int oC, oT, o_gs, o_off, ots, oto;
  const TO* res;             // identity residual, indexed like out (null: none)
  const S* bias;             // per output channel (null: none)
  int bias_after_round;      // convT: round, add the bias, round again
  int relu;
  const S* emul;             // backward: multiply by this plane (dropout mask), indexed like out
  const S* egt;              // backward: keep where this plane is > 0 (relu mask), indexed like out
  S* out2;                   // forward: out2 = round_s(out * mul)
  const S* mul;
  long long mul_sN, mul_sC, mul_sT;
};

// The fused epilogue of one output element (group g, group-local output
// channel o, position p = n*Tout + t), shared by the SIMT conv_kernel and the
// tensor-core and FMA engines (encoder_tc.cuh, encoder_fma.cuh): `va` is the
// conv's sum, `vb` the second operand's (read only where c.b is set). Each
// element reads its own residual before it writes, so c.res may be c.out.
template <typename S, typename TI, typename TO>
__device__ __forceinline__ void conv_store(const ConvArgs<S, TI, TO>& c, int g, int o, int p, float va,
                                           float vb) {
  const int n = p / c.Tout, t = p - n * c.Tout;
  const int to = t * c.ots + c.oto;
  const int oc = g * c.o_gs + c.o_off + o;
  const long long idx = ((long long)n * c.oC + oc) * c.oT + to;
  float v = va;
  if (c.b.x != nullptr) v = v + vb;
  if (c.res != nullptr) v = v + ld(c.res + idx);
  if (c.bias != nullptr && !c.bias_after_round) v = v + ld(c.bias + g * c.cog + o);
  if (c.relu) v = fmaxf(v, 0.f);
  if (c.emul != nullptr) v = v * ld(c.emul + idx);
  if (c.egt != nullptr && !(ld(c.egt + idx) > 0.f)) v = 0.f;
  if (std::is_same<TO, S>::value) v = round_s<S>(v);  // a forward plane
  if (c.bias != nullptr && c.bias_after_round) v = round_s<S>(v + ld(c.bias + g * c.cog + o));
  st(c.out + idx, v);
  if (c.out2 != nullptr) {
    const float m = ld(c.mul + n * c.mul_sN + (long long)oc * c.mul_sC + (long long)to * c.mul_sT);
    st(c.out2 + idx, v * m);
  }
}

template <typename S, typename TI>
__device__ __forceinline__ void conv_accumulate(const Operand<S, TI>& a, int g, int o0, int p0,
                                                int N, int Tout, float (*xs)[TP], float (*ws)[TC],
                                                float acc[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int R = a.cig * a.K;
  const S* wg = a.w + g * a.wsG;
  for (int r0 = 0; r0 < R; r0 += TR) {
    __syncthreads();  // the previous step's tiles are consumed
    for (int e = tid; e < TR * TP; e += THREADS) {
      const int rr = e / TP, pp = e % TP;
      const int r = r0 + rr, p = p0 + pp;
      float v = 0.f;
      if (r < R && p < N * Tout) {
        const int i = r / a.K, k = r - i * a.K;
        const int n = p / Tout, t = p - n * Tout;
        const int ti = t * a.stride + k - a.pad;
        if (ti >= 0 && ti < a.xT)
          v = round_s<S>(ld(a.x + ((long long)n * a.xC + g * a.x_gs + a.x_off + i) * a.xT + ti));
      }
      xs[rr][pp] = v;
    }
    for (int e = tid; e < TR * TC; e += THREADS) {
      const int rr = e / TC, oo = e % TC;
      const int r = r0 + rr;
      float v = 0.f;
      if (r < R) {
        const int i = r / a.K, k = r - i * a.K;
        v = ld(wg + (o0 + oo) * a.wsO + i * a.wsI + k * a.wsK);
      }
      ws[rr][oo] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < TR; ++rr) {
      float xv[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) xv[i] = xs[rr][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = ws[rr][ty + 16 * j];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(wv[j], xv[i], acc[j][i]);
    }
  }
}

// conv1's kernel (one input channel per group; every other conv runs on an
// engine): one operand, no c.b. grid: (ceil(N*Tout / TP), G*cog / TC); cog
// is a multiple of TC.
template <typename S, typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) conv_kernel(ConvArgs<S, TI, TO> c) {
  __shared__ float xs[TR][TP];
  __shared__ float ws[TR][TC];
  const int p0 = blockIdx.x * TP;
  const int oc0 = blockIdx.y * TC;     // group-local output channel tiles
  const int g = oc0 / c.cog, o0 = oc0 - g * c.cog;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  conv_accumulate<S, TI>(c.a, g, o0, p0, c.N, c.Tout, xs, ws, acc);

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + tx + 16 * i;
    if (p >= c.N * c.Tout) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) conv_store(c, g, o0 + ty + 16 * j, p, acc[j][i], 0.f);
  }
}

}  // namespace enc

// the bf16 tensor-core engine and the f32 FMA engine (they use ConvArgs and
// conv_store above)
#include "encoder_tc.cuh"
#include "encoder_fma.cuh"

namespace enc {

// ------------------------------------------------------- small forward kernels
// maxpool(k3, s2, p1) over the conv1 output c [N, C, 256] -> [N, C, 128]:
// out[t] = max(c[2t-1], c[2t], c[2t+1]), c[-1] = -inf.
template <typename S>
__global__ void maxpool_kernel(const S* __restrict__ c, S* __restrict__ out, long long rows) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * FEAT) return;
  const long long row = e / FEAT;
  const int t = (int)(e - row * FEAT);
  const S* src = c + row * 2 * FEAT;
  float m = ld(src + 2 * t);
  if (t > 0) m = fmaxf(ld(src + 2 * t - 1), m);
  m = fmaxf(m, ld(src + 2 * t + 1));
  st(out + e, m);
}

// roi_align in closed form, in the flat (channel, segment) order the z2_conv2
// groups see: A[n, c*7 + s, u] = round_s(round_s(mid[n, c]) * ramp[n, s, u]),
// mid = 0.5*z2f[n, c, 63] + 0.5*z2f[n, c, 64].
template <typename S>
__global__ void roi_align_kernel(const S* __restrict__ z2f, const S* __restrict__ ramp,
                                 S* __restrict__ A, int N, int C) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)N * C * SEGS * ALIGN) return;
  const int u = (int)(e % ALIGN);
  const int s = (int)((e / ALIGN) % SEGS);
  const long long nc = e / (ALIGN * SEGS);
  const int n = (int)(nc / C);
  const S* z = z2f + nc * FEAT;
  const float mid = round_s<S>(0.5f * ld(z + FEAT / 2 - 1) + 0.5f * ld(z + FEAT / 2));
  st(A + e, mid * ld(ramp + ((long long)n * SEGS + s) * ALIGN + u));
}

// out[i] = round_s(a[i] * mul(i)): the dropout products and the gate,
// recomputed from checkpointed planes. mul(i) = mul[i] (row_len 0) or
// mul[i / row_len] (per row).
template <typename S>
__global__ void mul_round_kernel(const S* __restrict__ a, const S* __restrict__ mul,
                                 S* __restrict__ out, long long n, int row_len) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  st(out + e, ld(a + e) * ld(mul + (row_len ? e / row_len : e)));
}

// ------------------------------------------------------------ launch helpers
inline int blocks_for(long long n, int per) { return (int)((n + per - 1) / per); }

template <typename S, typename TI>
Operand<S, TI> operand(const void* x, int xC, int xT, int x_gs, int x_off, const void* w,
                       long long wsG, long long wsO, long long wsI, long long wsK, int cig, int K,
                       int stride, int pad) {
  Operand<S, TI> a;
  a.x = static_cast<const TI*>(x);
  a.xC = xC; a.xT = xT; a.x_gs = x_gs; a.x_off = x_off;
  a.w = static_cast<const S*>(w);
  a.wsG = wsG; a.wsO = wsO; a.wsI = wsI; a.wsK = wsK;
  a.cig = cig; a.K = K; a.stride = stride; a.pad = pad;
  return a;
}

// A forward conv of torch weight w [G*cog, cig, K] over x (channel map
// g*x_gs + x_off + i).
template <typename S>
Operand<S, S> fwd_operand(const void* x, int xC, int xT, int x_gs, int x_off, const void* w,
                          int cog, int cig, int K, int stride, int pad) {
  return operand<S, S>(x, xC, xT, x_gs, x_off, w, (long long)cog * cig * K, (long long)cig * K, K, 1,
                       cig, K, stride, pad);
}

template <typename S, typename TI, typename TO>
ConvArgs<S, TI, TO> conv_args(const Operand<S, TI>& a, int N, int Tout, int cog, void* out, int oC,
                              int oT) {
  ConvArgs<S, TI, TO> c;
  c.a = a;
  c.b = a;
  c.b.x = nullptr;
  c.N = N; c.Tout = Tout; c.cog = cog;
  c.out = static_cast<TO*>(out);
  c.oC = oC; c.oT = oT; c.o_gs = cog; c.o_off = 0; c.ots = 1; c.oto = 0;
  c.res = nullptr; c.bias = nullptr; c.bias_after_round = 0; c.relu = 0;
  c.emul = nullptr; c.egt = nullptr;
  c.out2 = nullptr; c.mul = nullptr; c.mul_sN = c.mul_sC = c.mul_sT = 0;
  return c;
}

// the two packed-weight buffers of the engine of S (operands a and b), each
// pack_elems(L) values of S, in a scratch of pack_floats<S>(L) floats
template <typename S>
struct Pack {
  S* a;
  S* b;
};

// the largest conv of the chain is z2_conv2's, 7L groups of [128, 128, 3]
inline long long pack_elems(int L) { return 7LL * L * 128 * 128 * 3; }
template <typename S>
long long pack_floats(int L) {
  return 2 * pack_elems(L) * (long long)sizeof(S) / (long long)sizeof(float);
}

template <typename S>
Pack<S> pack_buffers(void* scratch, int L) {
  if (scratch == nullptr) return Pack<S>{nullptr, nullptr};
  S* p = static_cast<S*>(scratch);
  return Pack<S>{p, p + pack_elems(L)};
}

// Every conv but conv1 (16k input channels per group) runs on the engine of
// its storage type: bf16 on the tensor-core engine, float32 on the FMA
// engine; conv1 on conv_kernel. The choice depends on the shape and type
// alone, so a recompute takes the engine of the launch whose plane it
// replaces.
template <typename S, typename TI, typename TO>
cudaError_t launch_conv(const ConvArgs<S, TI, TO>& c, int G, cudaStream_t stream, const Pack<S>& pk) {
  if constexpr (std::is_same<S, __nv_bfloat16>::value) {
    if (tc::conv_ok(c.a.cig, c.cog, c.Tout) && (c.b.x == nullptr || tc::conv_ok(c.b.cig, c.cog, c.Tout))) {
      if (pk.a == nullptr) ENC_CHECK(cudaErrorInvalidValue);
      return tc::launch_conv_tc(c, G, pk.a, pk.b, stream);
    }
  }
  if constexpr (std::is_same<S, float>::value && std::is_same<TI, float>::value && std::is_same<TO, float>::value) {
    if (fma::conv_ok(c.a.cig, c.cog, c.Tout) && (c.b.x == nullptr || fma::conv_ok(c.b.cig, c.cog, c.Tout))) {
      if (pk.a == nullptr) ENC_CHECK(cudaErrorInvalidValue);
      return fma::launch_conv_fma(c, G, pk.a, pk.b, stream);
    }
  }
  if (c.b.x != nullptr) ENC_CHECK(cudaErrorInvalidValue);  // conv_kernel takes one operand
  const dim3 grid(blocks_for((long long)c.N * c.Tout, TP), G * c.cog / TC);
  auto kern = &conv_kernel<S, TI, TO>;
  ENC_LAUNCH(kern, grid, dim3(THREADS), stream, c);
  return cudaGetLastError();
}

// Set the per-element dropout product of a forward conv: out2 = round_s(out * m).
template <typename S, typename TI, typename TO>
void with_mask(ConvArgs<S, TI, TO>& c, const void* mask, void* out2) {
  if (mask == nullptr) return;  // eval: no dropout
  c.out2 = static_cast<S*>(out2);
  c.mul = static_cast<const S*>(mask);
  c.mul_sN = (long long)c.oC * c.oT;
  c.mul_sC = c.oT;
  c.mul_sT = 1;
}

// ------------------------------------------------------------ forward chain
// level 2: the whole chain; level 1: from the checkpointed tower planes
// (h0..h3, r1_0..r1_2): conv1, the dropout products and the gate are
// recomputed, then the post-tower stages; level 0: nothing (every plane is
// checkpointed). `train` selects the dropout products (masks non-null).
// `scratch`: the engine's packed weights (pack_buffers).
template <typename S>
int forward_chain(void* const* P, int B, int L, int level, int train, cudaStream_t st, void* scratch) {
  if (level <= 0) return 0;
  const Pack<S> pk = pack_buffers<S>(scratch, L);
  const int C = FEAT * L, G7 = SEGS * L, Cz = FEAT * G7, Ch = 64 * G7;
  const int T = FEAT;
  const long long plane = (long long)B * C * T;
  const char* m6 = static_cast<const char*>(train ? P[M6] : nullptr);
  auto mask6 = [&](int i) -> const void* { return m6 ? m6 + i * plane * sizeof(S) : nullptr; };

  // conv1 (k15, s2, p7, one input channel per lead) + relu -> c [B, C, 256]
  {
    auto c = conv_args<S, S, S>(fwd_operand<S>(P[X], L, SEQ, 1, 0, P[W_C1], FEAT, 1, 15, 2, 7),
                                B, 2 * T, FEAT, P[P_C], C, 2 * T);
    c.relu = 1;
    ENC_TRY(launch_conv(c, L, st, pk));
  }
  const void* r1m[3] = {train ? P[P_R1M_0] : P[P_R1_0], train ? P[P_R1M_1] : P[P_R1_1],
                        train ? P[P_R1M_2] : P[P_R1_2]};
  const int hs[4] = {P_H0, P_H1, P_H2, P_H3};
  const int r1s[3] = {P_R1_0, P_R1_1, P_R1_2};
  const int wk[6] = {W_L0C1, W_L0C2, W_L1C1, W_L1C2, W_L2C1, W_L2C2};
  if (level >= 2) {
    auto kern = &maxpool_kernel<S>;
    ENC_LAUNCH(kern, dim3(blocks_for(plane, 256)), dim3(256), st, static_cast<const S*>(P[P_C]),
               static_cast<S*>(P[P_H0]), (long long)B * C);
    ENC_TRY(cudaGetLastError());
    // layer1: 3 BasicBlocks (k7, identity residual); the last one's output
    // also writes hg = round_s(h3 * gate)
    for (int b = 0; b < 3; ++b) {
      auto c1 = conv_args<S, S, S>(fwd_operand<S>(P[hs[b]], C, T, FEAT, 0, P[wk[2 * b]], FEAT, FEAT, 7, 1, 3),
                                   B, T, FEAT, P[r1s[b]], C, T);
      c1.relu = 1;
      with_mask(c1, mask6(b), const_cast<void*>(r1m[b]));
      ENC_TRY(launch_conv(c1, L, st, pk));
      auto c2 = conv_args<S, S, S>(fwd_operand<S>(r1m[b], C, T, FEAT, 0, P[wk[2 * b + 1]], FEAT, FEAT, 7, 1, 3),
                                   B, T, FEAT, P[hs[b + 1]], C, T);
      c2.relu = 1;
      c2.res = static_cast<const S*>(P[hs[b]]);
      if (b == 2) {
        c2.out2 = static_cast<S*>(P[P_HG]);
        c2.mul = static_cast<const S*>(P[GATE]);
        c2.mul_sN = C; c2.mul_sC = 1; c2.mul_sT = 0;
      }
      ENC_TRY(launch_conv(c2, L, st, pk));
    }
  } else {
    const int nb = blocks_for(plane, 256);
    auto kern = &mul_round_kernel<S>;
    if (train) {
      for (int b = 0; b < 3; ++b) {
        ENC_LAUNCH(kern, dim3(nb), dim3(256), st, static_cast<const S*>(P[r1s[b]]),
                   static_cast<const S*>(mask6(b)), static_cast<S*>(const_cast<void*>(r1m[b])), plane, 0);
        ENC_TRY(cudaGetLastError());
      }
    }
    ENC_LAUNCH(kern, dim3(nb), dim3(256), st, static_cast<const S*>(P[P_H3]),
               static_cast<const S*>(P[GATE]), static_cast<S*>(P[P_HG]), plane, T);
    ENC_TRY(cudaGetLastError());
  }

  // w_conv.0 (k3, identity residual)
  const void* wr1m = train ? P[P_WR1M] : P[P_WR1];
  {
    auto c1 = conv_args<S, S, S>(fwd_operand<S>(P[P_HG], C, T, FEAT, 0, P[W_WC1], FEAT, FEAT, 3, 1, 1),
                                 B, T, FEAT, P[P_WR1], C, T);
    c1.relu = 1;
    with_mask(c1, mask6(3), const_cast<void*>(wr1m));
    ENC_TRY(launch_conv(c1, L, st, pk));
    auto c2 = conv_args<S, S, S>(fwd_operand<S>(wr1m, C, T, FEAT, 0, P[W_WC2], FEAT, FEAT, 3, 1, 1),
                                 B, T, FEAT, P[P_HW], C, T);
    c2.relu = 1;
    c2.res = static_cast<const S*>(P[P_HG]);
    ENC_TRY(launch_conv(c2, L, st, pk));
  }

  // z1_conv.0 / z2_conv1.0 on the per-lead channel halves of hw (k3, 1x1
  // residual conv with bias)
  for (int z = 0; z < 2; ++z) {
    const int zr1 = z ? P_ZR12 : P_ZR11, zr1m = z ? P_ZR1M2 : P_ZR1M1, zf = z ? P_Z2F : P_Z1F;
    const void* zr1m_p = train ? P[zr1m] : P[zr1];
    auto c1 = conv_args<S, S, S>(
        fwd_operand<S>(P[P_HW], C, T, FEAT, 64 * z, P[z ? W_Z2W1 : W_Z1W1], FEAT, 64, 3, 1, 1),
        B, T, FEAT, P[zr1], C, T);
    c1.relu = 1;
    with_mask(c1, mask6(4 + z), const_cast<void*>(zr1m_p));
    ENC_TRY(launch_conv(c1, L, st, pk));
    auto c2 = conv_args<S, S, S>(fwd_operand<S>(zr1m_p, C, T, FEAT, 0, P[z ? W_Z2W2 : W_Z1W2], FEAT, FEAT, 3, 1, 1),
                                 B, T, FEAT, P[zf], C, T);
    c2.b = fwd_operand<S>(P[P_HW], C, T, FEAT, 64 * z, P[z ? W_Z2WR : W_Z1WR], FEAT, 64, 1, 1, 0);
    c2.bias = static_cast<const S*>(P[z ? B_Z2 : B_Z1]);
    c2.relu = 1;
    ENC_TRY(launch_conv(c2, L, st, pk));
  }

  // roi_align -> A [B, Cz, 16]
  {
    auto kern = &roi_align_kernel<S>;
    ENC_LAUNCH(kern, dim3(blocks_for((long long)B * Cz * ALIGN, 256)), dim3(256), st,
               static_cast<const S*>(P[P_Z2F]), static_cast<const S*>(P[RAMP]), static_cast<S*>(P[P_A]), B, C);
    ENC_TRY(cudaGetLastError());
  }

  // z2_conv2.0 (k3 over 16 steps, G7 groups, identity residual)
  const void* c1m = train ? P[P_C1M] : P[P_C1];
  {
    auto c1 = conv_args<S, S, S>(fwd_operand<S>(P[P_A], Cz, ALIGN, FEAT, 0, P[W_C20W1], FEAT, FEAT, 3, 1, 1),
                                 B, ALIGN, FEAT, P[P_C1], Cz, ALIGN);
    c1.relu = 1;
    with_mask(c1, train ? P[MC20] : nullptr, const_cast<void*>(c1m));
    ENC_TRY(launch_conv(c1, G7, st, pk));
    auto c2 = conv_args<S, S, S>(fwd_operand<S>(c1m, Cz, ALIGN, FEAT, 0, P[W_C20W2], FEAT, FEAT, 3, 1, 1),
                                 B, ALIGN, FEAT, P[P_HC], Cz, ALIGN);
    c2.relu = 1;
    c2.res = static_cast<const S*>(P[P_A]);
    ENC_TRY(launch_conv(c2, G7, st, pk));
  }

  // z2_conv2.1: ConvTranspose1d(k2, s2), torch weight [Cz, 64, 2], as one
  // 1x1 conv per tap writing every other output step; the products round
  // to S before the bias, as the TPU kernel's do
  for (int k = 0; k < 2; ++k) {
    const S* wt = static_cast<const S*>(P[W_T]) + k;
    auto c = conv_args<S, S, S>(operand<S, S>(P[P_HC], Cz, ALIGN, FEAT, 0, wt, (long long)FEAT * 128, 2, 128, 0,
                                              FEAT, 1, 1, 0),
                                B, ALIGN, 64, P[P_HT], Ch, 2 * ALIGN);
    c.ots = 2;
    c.oto = k;
    c.bias = static_cast<const S*>(P[B_T]);
    c.bias_after_round = 1;
    ENC_TRY(launch_conv(c, G7, st, pk));
  }

  // z2_conv2.2 (k3 over 32 steps, 64 -> 128 channels per group, 1x1 residual conv with bias)
  const void* c2m = train ? P[P_C2M] : P[P_C2];
  {
    auto c1 = conv_args<S, S, S>(fwd_operand<S>(P[P_HT], Ch, 2 * ALIGN, 64, 0, P[W_C22W1], FEAT, 64, 3, 1, 1),
                                 B, 2 * ALIGN, FEAT, P[P_C2], Cz, 2 * ALIGN);
    c1.relu = 1;
    with_mask(c1, train ? P[MC22] : nullptr, const_cast<void*>(c2m));
    ENC_TRY(launch_conv(c1, G7, st, pk));
    auto c2 = conv_args<S, S, S>(fwd_operand<S>(c2m, Cz, 2 * ALIGN, FEAT, 0, P[W_C22W2], FEAT, FEAT, 3, 1, 1),
                                 B, 2 * ALIGN, FEAT, P[P_Z2G], Cz, 2 * ALIGN);
    c2.b = fwd_operand<S>(P[P_HT], Ch, 2 * ALIGN, 64, 0, P[W_C22WR], FEAT, 64, 1, 1, 0);
    c2.bias = static_cast<const S*>(P[B_C22]);
    c2.relu = 1;
    ENC_TRY(launch_conv(c2, G7, st, pk));
  }
  return 0;
}

}  // namespace enc
