// The float32 stage kernel of the eval decoder (see decoder_common.cuh): each
// convolution stage as plain FMA at full float32 (no TF32, no tensor cores).
//
// Planes are [C][time] float32. A block takes one view and walks its tiles of
// 128 steps x NOUT output channels; a thread holds 8 channels x (4 + 4)
// steps in registers. Per 16 input channels the weights [tap][ci][n] and the
// input rows [ci][time] of the next step are staged in the other half of a
// double buffer (cp.async for copies; the basis mix, the gate product and
// the upsample of the gate products are computed into it) while the current
// one is consumed with float4 shared loads: 12 loads feed 192 FMAs. The
// weights are packed [tap][ci][n] by the wrapper so that staging is a
// straight 16-byte copy and the inner loads are conflict free.

#pragma once

#include "decoder_common.cuh"

namespace dec {
namespace fma {

constexpr int TM = 128;     // time steps per tile
constexpr int CI_T = 16;    // input channels per step
constexpr int XW = TM + 8;  // staged row: steps t0 - 4 .. t0 + TM + 3, 16-byte groups
constexpr int SP_W = T2 + 4;

template <int NOUT, int TAPS, int OUT>
struct Smem {
  static constexpr int X = CI_T * XW * 4;
  static constexpr int W = TAPS * CI_T * NOUT * 4;
  static constexpr int OFF_W = 2 * X;
  static constexpr int OFF_CORR = OFF_W + 2 * W;       // 128 floats, OUT_POLY
  static constexpr int OFF_RED = OFF_CORR + 128 * 4;   // OUT_CONV5: [NOUT / 8][3][TM] partial sums
  static constexpr int OFF_SP = OFF_RED + (OUT == OUT_CONV5 ? (NOUT / 8) * 3 * TM * 4 : 0);
  static constexpr int BYTES = OFF_SP + (OUT == OUT_CONV5 ? 3 * SP_W * 4 : 0);
};

__device__ __forceinline__ float4 relu4(float4 v, float b) {
  return make_float4(fmaxf(v.x + b, 0.f), fmaxf(v.y + b, 0.f), fmaxf(v.z + b, 0.f), fmaxf(v.w + b, 0.f));
}

// y1[c][t] from the gate stage's products g [3][128][128]
__device__ __forceinline__ float g3_value(const float* g, int c, int t) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int p = t + k - 1;
    if (p < 0 || p >= T1) continue;
    int s, s2;
    up2_taps(p, s, s2);
    const float* row = g + (k * C1 + c) * T0;
    acc += fmaf(0.25f, __ldg(row + s2), 0.75f * __ldg(row + s));
  }
  return acc;
}

// Stages input channels ci0 .. ci0 + 15 of view n at steps t0 - 4 .. t0 + TM + 3
// into xs [CI_T][XW] (zero outside [0, T)) and their weights into ws.
template <int CIN, int NOUT, int T, int TAPS, int IN, int THREADS>
__device__ __forceinline__ void stage(float* xs, float* ws, const StageArgs& a, const float* w, int n,
                                      int t0, int ci0) {
  const int tid = threadIdx.x;
  constexpr int WG = NOUT / 4;  // 16-byte groups per weight row
  for (int e = tid; e < TAPS * CI_T * WG; e += THREADS) {
    const int row = e / WG, col = e % WG;  // row = k * CI_T + ci
    const int k = row / CI_T, ci = row % CI_T;
    cp_async16(smem_u32(ws + row * NOUT + col * 4), w + ((size_t)(k * CIN + ci0 + ci) * NOUT + col * 4));
  }
  constexpr int XG = XW / 4;  // 34 groups per row
  for (int e = tid; e < CI_T * XG; e += THREADS) {
    const int ci = e / XG, grp = e - ci * XG;
    const int c = ci0 + ci, t = t0 - 4 + grp * 4;
    const bool valid = t >= 0 && t < T;
    float* dst = xs + ci * XW + grp * 4;
    if (IN == IN_PLANE || IN == IN_Y1) {
      const float* src = static_cast<const float*>(a.in) + ((size_t)n * CIN + c) * T;
      cp_async16(smem_u32(dst), src + (valid ? t : 0), valid);
    } else {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (valid) {
        if (IN == IN_MIX) {
          const int J = a.J;
          const float* U = static_cast<const float*>(a.in) + ((size_t)(n / a.views) * J * CIN + c) * T + t;
          const float* ep = a.ep + (size_t)n * J;
          // four basis planes' loads in flight before their FMAs
          int j = 0;
          for (; j + 4 <= J; j += 4) {
            float4 u[4];
            float e[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              u[x] = __ldg(reinterpret_cast<const float4*>(U + (size_t)(j + x) * CIN * T));
              e[x] = __ldg(ep + j + x);
            }
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              v.x = fmaf(e[x], u[x].x, v.x), v.y = fmaf(e[x], u[x].y, v.y);
              v.z = fmaf(e[x], u[x].z, v.z), v.w = fmaf(e[x], u[x].w, v.w);
            }
          }
          for (; j < J; ++j) {
            const float e1 = __ldg(ep + j);
            const float4 u = __ldg(reinterpret_cast<const float4*>(U + (size_t)j * CIN * T));
            v.x = fmaf(e1, u.x, v.x), v.y = fmaf(e1, u.y, v.y), v.z = fmaf(e1, u.z, v.z), v.w = fmaf(e1, u.w, v.w);
          }
          v = relu4(v, a.b_in[c]);
        } else if (IN == IN_G3) {
          const float* g = static_cast<const float*>(a.in) + (size_t)n * 3 * C1 * T0;
          v = relu4(make_float4(g3_value(g, c, t), g3_value(g, c, t + 1), g3_value(g, c, t + 2),
                                g3_value(g, c, t + 3)),
                    a.b_in[c]);
        } else {  // IN_GATE
          const float g = __ldg(a.ep + (size_t)n * CIN + c);
          const float4 u = __ldg(reinterpret_cast<const float4*>(
              static_cast<const float*>(a.in) + ((size_t)(n / a.views) * CIN + c) * T + t));
          v = make_float4(__fmul_rn(g, u.x), __fmul_rn(g, u.y), __fmul_rn(g, u.z), __fmul_rn(g, u.w));
        }
      }
      *reinterpret_cast<float4*>(dst) = v;
    }
  }
  cp_async_commit();
}

// One stage over all views. grid.x: views; grid.y: slices of the output
// channels that have their own weights and output plane (the gate stage's
// three taps), else 1.
template <int CIN, int NOUT, int T, int TAPS, int IN, int OUT, bool RELU>
__global__ void __launch_bounds__(16 * (NOUT / 8), 2) stage_kernel(const StageArgs a) {
  using L = Smem<NOUT, TAPS, OUT>;
  constexpr int THREADS = 16 * (NOUT / 8), TILES = T / TM, KS = CIN / CI_T, STEPS = TILES * KS;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs[2] = {reinterpret_cast<float*>(smem), reinterpret_cast<float*>(smem + L::X)};
  float* ws[2] = {reinterpret_cast<float*>(smem + L::OFF_W), reinterpret_cast<float*>(smem + L::OFF_W + L::W)};
  float* scorr = reinterpret_cast<float*>(smem + L::OFF_CORR);
  float* red = reinterpret_cast<float*>(smem + L::OFF_RED);
  float* sp = reinterpret_cast<float*>(smem + L::OFF_SP);

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int tA = tx * 4, tB = 64 + tx * 4, n0 = ty * 8;
  const int n = blockIdx.x;
  const float* w = static_cast<const float*>(a.w) + (size_t)blockIdx.y * TAPS * CIN * NOUT;

  if (OUT == OUT_CONV5)
    for (int e = tid; e < 3 * SP_W; e += THREADS) sp[e] = 0.f;

  float accA[8][4], accB[8][4];
  stage<CIN, NOUT, T, TAPS, IN, THREADS>(xs[0], ws[0], a, w, n, 0, 0);

#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    const int tile = s / KS, ks = s - tile * KS, t0 = tile * TM;
    if (ks == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) accA[j][i] = accB[j][i] = 0.f;
      if (OUT == OUT_POLY && tid < C1) {
        // the clamp's correction on the view's first two or last two output
        // steps: corr[n] = sum_ci C[side][n][ci] * h[ci] at the edge step
        const float4* ce = static_cast<const float4*>(a.cedge) + ((size_t)tile * NOUT + tid) * (CIN / 4);
        const float* h = static_cast<const float*>(a.in) + (size_t)n * CIN * T + (tile == 0 ? 0 : T - 1);
        float c = 0.f;
#pragma unroll 4
        for (int ci = 0; ci < CIN / 4; ++ci) {
          const float4 cv = __ldg(ce + ci);
          c = fmaf(cv.x, __ldg(h + (size_t)(4 * ci) * T), c);
          c = fmaf(cv.y, __ldg(h + (size_t)(4 * ci + 1) * T), c);
          c = fmaf(cv.z, __ldg(h + (size_t)(4 * ci + 2) * T), c);
          c = fmaf(cv.w, __ldg(h + (size_t)(4 * ci + 3) * T), c);
        }
        scorr[tid] = c;
      }
    }
    if (s + 1 < STEPS) {
      const int tile1 = (s + 1) / KS, ks1 = s + 1 - tile1 * KS;
      stage<CIN, NOUT, T, TAPS, IN, THREADS>(xs[(s + 1) & 1], ws[(s + 1) & 1], a, w, n, tile1 * TM, ks1 * CI_T);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      cp_async_wait_all();
    }
    __syncthreads();

    const float* x = xs[s & 1];
    const float* wk = ws[s & 1] + n0;
#pragma unroll 4
    for (int ci = 0; ci < CI_T; ++ci) {
      float xa[6], xb[6];
      const float* xr = x + ci * XW;
      const float4 va = *reinterpret_cast<const float4*>(xr + 4 + tA);
      const float4 vb = *reinterpret_cast<const float4*>(xr + 4 + tB);
      xa[1] = va.x, xa[2] = va.y, xa[3] = va.z, xa[4] = va.w;
      xb[1] = vb.x, xb[2] = vb.y, xb[3] = vb.z, xb[4] = vb.w;
      if (TAPS == 3) xa[0] = xr[3 + tA], xa[5] = xr[8 + tA], xb[0] = xr[3 + tB], xb[5] = xr[8 + tB];
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int sh = TAPS == 3 ? k : 1;
        const float4 w0 = *reinterpret_cast<const float4*>(wk + (k * CI_T + ci) * NOUT);
        const float4 w1 = *reinterpret_cast<const float4*>(wk + (k * CI_T + ci) * NOUT + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            accA[j][i] = fmaf(wv[j], xa[i + sh], accA[j][i]);
            accB[j][i] = fmaf(wv[j], xb[i + sh], accB[j][i]);
          }
      }
    }
    __syncthreads();
    if (ks != KS - 1) continue;

    // the tile's epilogue
    if (OUT == OUT_PLANE) {
      float* out = static_cast<float*>(a.out) + ((size_t)n * gridDim.y + blockIdx.y) * NOUT * T;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = RELU ? a.bias[n0 + j] : 0.f;
        float4 va = make_float4(accA[j][0] + b, accA[j][1] + b, accA[j][2] + b, accA[j][3] + b);
        float4 vb = make_float4(accB[j][0] + b, accB[j][1] + b, accB[j][2] + b, accB[j][3] + b);
        if (RELU) va = relu4(va, 0.f), vb = relu4(vb, 0.f);
        float* row = out + (size_t)(n0 + j) * T + t0;
        *reinterpret_cast<float4*>(row + tA) = va;
        *reinterpret_cast<float4*>(row + tB) = vb;
      }
    } else if (OUT == OUT_POLY) {
      // packed channel 2 co + phase -> output step 2 t + phase of channel co
      float* out = static_cast<float*>(a.out) + (size_t)n * C2 * T2;
      if (t0 + tA == 0)
#pragma unroll
        for (int j = 0; j < 8; ++j) accA[j][0] += scorr[n0 + j];
      if (t0 + tB + 3 == T - 1)
#pragma unroll
        for (int j = 0; j < 8; ++j) accB[j][3] += scorr[n0 + j];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float be = a.bias[n0 + 2 * jj], bo = a.bias[n0 + 2 * jj + 1];
        float* row = out + (size_t)(n0 / 2 + jj) * T2 + 2 * t0;
        const float(&ea)[4] = accA[2 * jj], (&oa)[4] = accA[2 * jj + 1];
        const float(&eb)[4] = accB[2 * jj], (&ob)[4] = accB[2 * jj + 1];
#define DEC_RELU(v, b) fmaxf((v) + (b), 0.f)
        *reinterpret_cast<float4*>(row + 2 * tA) =
            make_float4(DEC_RELU(ea[0], be), DEC_RELU(oa[0], bo), DEC_RELU(ea[1], be), DEC_RELU(oa[1], bo));
        *reinterpret_cast<float4*>(row + 2 * tA + 4) =
            make_float4(DEC_RELU(ea[2], be), DEC_RELU(oa[2], bo), DEC_RELU(ea[3], be), DEC_RELU(oa[3], bo));
        *reinterpret_cast<float4*>(row + 2 * tB) =
            make_float4(DEC_RELU(eb[0], be), DEC_RELU(ob[0], bo), DEC_RELU(eb[1], be), DEC_RELU(ob[1], bo));
        *reinterpret_cast<float4*>(row + 2 * tB + 4) =
            make_float4(DEC_RELU(eb[2], be), DEC_RELU(ob[2], bo), DEC_RELU(eb[3], be), DEC_RELU(ob[3], bo));
#undef DEC_RELU
      }
    } else {
      // conv5's three tap sums: over this thread's 8 channels, then over the
      // channel groups in a fixed order, so a repeat launch is bitwise equal
      const float* w5 = static_cast<const float*>(a.w5);
      float pa[3][4], pb[3][4];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[k][i] = pb[k][i] = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float b = a.bias[n0 + j];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float wv = __ldg(w5 + k * C2 + n0 + j);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pa[k][i] = fmaf(wv, fmaxf(accA[j][i] + b, 0.f), pa[k][i]);
            pb[k][i] = fmaf(wv, fmaxf(accB[j][i] + b, 0.f), pb[k][i]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        *reinterpret_cast<float4*>(red + (ty * 3 + k) * TM + tA) = make_float4(pa[k][0], pa[k][1], pa[k][2], pa[k][3]);
        *reinterpret_cast<float4*>(red + (ty * 3 + k) * TM + tB) = make_float4(pb[k][0], pb[k][1], pb[k][2], pb[k][3]);
      }
      __syncthreads();
      for (int e = tid; e < 3 * TM; e += THREADS) {
        const int k = e / TM, t = e - k * TM;
        float p = 0.f;
#pragma unroll
        for (int g = 0; g < NOUT / 8; ++g) p += red[(g * 3 + k) * TM + t];
        sp[k * SP_W + 1 + t0 + t] = p;
      }
      if (tile == TILES - 1) {
        __syncthreads();
        // out[t] = p0[t - 1] + p1[t] + p2[t + 1]
        float* out = static_cast<float*>(a.out) + (size_t)n * T;
        const float b5 = a.b5[0];
        for (int t = tid; t < T; t += THREADS)
          out[t] = sigmoid_third(sp[t] + sp[SP_W + 1 + t] + sp[2 * SP_W + 2 + t] + b5);
      }
    }
  }
}

template <int CIN, int NOUT, int T, int TAPS, int IN, int OUT, bool RELU>
cudaError_t launch_stage(const StageArgs& a, int slices, cudaStream_t stream) {
  using L = Smem<NOUT, TAPS, OUT>;
  auto kernel = stage_kernel<CIN, NOUT, T, TAPS, IN, OUT, RELU>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(a.N, slices), dim3(16 * (NOUT / 8)), L::BYTES, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace fma
}  // namespace dec
