// The bfloat16 tensor-core engine of the fused train decoder, backward (A4b,
// decoder_train_bwd.cu) and forward (A4f, decoder_train_fwd.cu; the backward
// reduces its partials with the SIMT dw_reduce_kernel and bias_reduce_kernel
// of decoder_train_common.cuh) for Hopper, sm_90a: the data gradients, the
// weight gradients and the forward convs of conv1..conv4 as implicit GEMMs on
// `mma.sync.m16n8k16` bf16 products with float32 accumulators. The float32
// instantiations run them on the FMA engine of decoder_train_fma.cuh, and
// conv5 (one output channel), BatchNorm (moments, normalisation, backward),
// the sigmoid and the up2 adjoints stay SIMT in both.
//
// Replaces, with those, the TPU kernels
// electrocardio_panorama_tpu/ops/pallas/decoder_train.py::_train_fwd_kernel
// and ::_train_bwd_kernel.
//
// Rounding. A float gradient plane rounds to bf16 (nearest even) as it is
// staged, where the plain version rounds it (round_s, GradRound), and the
// forward's planes are bf16 already: every product is of two bf16 values,
// exact in float32, so only the order of the float32 sums differs.
//
// Data gradients (dgrad_kernel_tc): out[n, q, t] = sum over (k, r) of
// w[2 - k, r, q] * dy[n, r, t + k - 1], the forward's weights transposed and
// flipped, 64 output channels x 64 positions of one sample per block, four
// warps of 32 x 32. The block stages dy's rows t0 - 1 .. t0 + 64 once as
// channel chunks [C/8][row][8] bf16: one step of 8 channels is a 16-byte row,
// 8 rows are one 8x8 matrix for `ldmatrix`, and a tap is a row offset. The
// weights are packed once per launch into [tap][C/8][q][8] (pack_dgrad_kernel)
// and streamed tap by tap with cp.async into a double buffer.
//
// Weight gradients (dw_kernel_tc): dW_k[o][i] = sum_p dy[o][p] * X[i][p + k -
// 1], a 64 x 64 tile of (o, i) for all three taps per block over one of a
// fixed set of position ranges. Per chunk of 64 positions dy is staged as
// [p/8][o][8] (the A operand) and X with the taps' halo as [i/8][row][8],
// read through ldmatrix.trans, so a tap is again a row offset and one dy
// fragment serves three products. The next chunk loads into registers while
// this one's products run. Partials leave as whole rows through shared
// memory; a reduce kernel adds the ranges in a fixed order (no atomics, so a
// repeat launch gives the same bits; the ranges depend on the shape alone).
// The conv's bias gradient, the sum of the unrounded dy, rides along: the
// blocks of the first input-channel tile sum the dy they stage, and
// bias_reduce_kernel adds their partials in order (on an H100 a SIMT
// kernel with one block per channel took 0.16 ms of a 1.01 ms launch).
//
// The upsampled convs (conv1 on up2(x), conv3 on up2(h2)). up2(h) is
// 0.75 * h[m] + 0.25 * h[m -+ 1] (clamped at the ends), a float that is not a
// bf16 value, and the plain version multiplies it unrounded. So the weight
// gradient is split by output phase: with dy_p[m] = dy[2m + p] and h's halo
// clamped (h[-1] = h[0], h[Th] = h[Th - 1]), the engine sums
// S_p,s = sum over (n, m) of dy_p[m] * h[m + s] for s = -1, 0, +1 (every product
// bf16 x bf16), and dw_reduce_up_kernel applies the weights in float32:
//   dW_0 = .75 S_0,-1 + .25 S_0,0 + .75 S_1,0 + .25 S_1,-1 - sum_n dy_0[0] h[0]
//   dW_1 = .75 (S_0,0 + S_1,0) + .25 (S_0,-1 + S_1,+1)
//   dW_2 = .75 S_0,0 + .25 S_0,+1 + .75 S_1,+1 + .25 S_1,0 - sum_n dy_1[Th-1] h[Th-1]
// (the last terms take out the tap that falls on the conv's zero padding,
// which the clamped halo would count). The phases are two halves of the
// block rows, dy read with stride 2.
//
// Forward convs (conv_fwd_kernel_tc). The weights are packed once per conv
// launch into [Cin/8][tap][Cout][8] (pack_fwd_tc_kernel) and streamed FK input
// channels at a time, every tap's rows together, with cp.async into a double
// buffer; x's rows are staged once per block as [C/8][row][8], as dy is for a
// data gradient, and h1..h3 and x are bf16 already, so every product is of
// two bf16 values and only the order of the float32 sums differs from the
// plain version. conv2 and conv4 (UP 0): 64 output channels x 64 positions of
// one sample per block, four warps of 32 x 32, a tap a row offset, the bias
// added in the store. conv1 and conv3 run at input resolution (UP 1): up2 is
// linear per channel in time, so conv3(up2(x); W)[t] = b + sum over k of
// up2(Y_k)[t + k - 1] with Y_k = W_k x, a 1x1 product per tap at x's Th
// steps, half the products of the conv over up2(x). A block takes 64 output
// channels x 3 taps against 64 input positions and the halo of one on each
// side (staged rows clamped into the sample, up2's edge; 72 rows, 9 n8
// tiles), each warp 16 channels x 3 taps; Y, never rounded, goes through
// shared memory, and the epilogue forms each of the 128 output steps from
// the up2 weights in float32, leaving out a tap that falls on the conv's zero
// padding. Neither the up2 weights nor up2(x) are rounded to bf16: the plain
// version multiplies up2's float32 values.
//
// Bound. At 3 groups of 32 the eight products are 21.8 GFLOP, 0.022 ms at
// the bf16 peak of an H100, and the kept planes, dout and the gradients are
// about 0.1 GB, 0.03 ms at 3.35 TB/s. The float gradient planes (12.6 MB
// each) that the SIMT BN, conv5 and up2 stages pass between the engine's
// launches, and the staging of its operands, set the time, not the products.
// The forward's four convs at input resolution are 7.2 GFLOP (0.007 ms)
// against the 88 MB that A4f reads and writes (x, the weights, the planes it
// keeps for the backward, out and the moments; 0.026 ms): bytes bound it, and
// the conv stages write each pre-BN plane once, in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decoder_train_common.cuh"
#include "tc_ptx.cuh"

namespace dtr {
namespace tc {

using namespace tcptx;  // cp.async, ldmatrix, mma.sync, bf16 packing
using bf16 = __nv_bfloat16;

constexpr int BM = 64;            // output channels per block
constexpr int BN = 64;            // positions per data-gradient block, input channels per weight-gradient block
constexpr int BP = 64;            // positions per staged chunk of a weight gradient
constexpr int ROWS = BN + 2;      // staged input rows: 64 steps and the taps' halo
constexpr int THREADS = 128;      // data-gradient blocks: four warps, 2 x 2, each 32 x 32
constexpr int DW_THREADS = 256;   // weight-gradient blocks: eight warps, 2 (o) x 4 (i), each 32 x 16 per tap
constexpr int X_BATCH = 4;        // input rows a data-gradient thread loads at once
constexpr int MAX_RANGES = 64;    // position ranges per weight gradient
constexpr int TARGET_BLOCKS = 396;  // three weight-gradient blocks per SM

// ------------------------------------------------------------ data gradients
// wp[((k*Cfo/8 + c)*Cfi + q)*8 + j] = w[2 - k, c*8 + j, q] from the forward's
// weights w [3, Cfo, Cfi]: the data gradient's A rows, taps flipped.
__global__ void pack_dgrad_kernel(const bf16* __restrict__ w, int Cfo, int Cfi, bf16* __restrict__ wp) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * Cfo * Cfi) return;
  const int j = e & 7;
  int r = e >> 3;
  const int q = r % Cfi;
  r /= Cfi;
  const int c = r % (Cfo / 8), k = r / (Cfo / 8);
  wp[e] = w[((2 - k) * Cfo + c * 8 + j) * Cfi + q];
}

inline int dgrad_smem_bytes(int Cfo) { return (Cfo / 8) * (ROWS + 2 * BM) * 16; }

// grid: (N*T / BN, Cfi / BM); dy [N, Cfo, T] float, out [N, Cfi, T] float;
// T a multiple of BN, Cfo of 16, Cfi of BM.
__global__ void __launch_bounds__(THREADS) dgrad_kernel_tc(const float* __restrict__ dy,
                                                          const bf16* __restrict__ wp, float* __restrict__ out,
                                                          int Cfo, int Cfi, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int chunks = Cfo / 8;
  uint4* xs = reinterpret_cast<uint4*>(smem);  // [chunks][ROWS]
  uint4* ws = xs + chunks * ROWS;              // [2][chunks][BM]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int p0 = blockIdx.x * BN;
  const int n = p0 / T, t0 = p0 - n * T;
  const int q0 = blockIdx.y * BM;
  const int w_items = chunks * BM;
  const uint4* wsrc = reinterpret_cast<const uint4*>(wp) + q0;
  auto stage_w = [&](int k, int buf) {
    uint4* dst = ws + buf * w_items;
    const uint4* src = wsrc + (long long)k * chunks * Cfi;
    for (int e = tid; e < w_items; e += THREADS) {
      const int c = e / BM, o = e - c * BM;
      cp_async16(smem_u32(dst + e), src + (long long)c * Cfi + o);
    }
    cp_async_commit();
  };
  stage_w(0, 0);

  // dy's rows t0 - 1 .. t0 + BN of this sample, rounded to bf16; X_BATCH
  // rows of 8 channels per thread in flight at once
  const float* base = dy + (long long)n * Cfo * T;
  const int x_items = chunks * ROWS;
  for (int e0 = tid; e0 < x_items; e0 += X_BATCH * THREADS) {
    float f[X_BATCH][8];
#pragma unroll
    for (int u = 0; u < X_BATCH; ++u) {
      const int e = e0 + u * THREADS;
      const int c = e / ROWS, t = t0 - 1 + (e - c * ROWS);
      const bool in = e < x_items && t >= 0 && t < T;
      const float* src = base + (long long)c * 8 * T + t;
#pragma unroll
      for (int j = 0; j < 8; ++j) f[u][j] = in ? src[(long long)j * T] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < X_BATCH; ++u)
      if (e0 + u * THREADS < x_items) xs[e0 + u * THREADS] = pack8(f[u]);
  }

  // per lane: the A row (weights) and the B rows (dy) of its ldmatrix
  const uint32_t a_lane = ((lane >> 4) * BM + wm * 32 + (lane & 15)) * 16;
  uint32_t b_lane[2];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj)
    b_lane[nj] = (((lane >> 3) & 1) * ROWS + wn * 32 + nj * 16 + ((lane >> 4) << 3) + (lane & 7)) * 16;
  const uint32_t xs_u = smem_u32(xs), ws_u = smem_u32(ws);

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
  for (int k = 0; k < 3; ++k) {
    if (k + 1 < 3) {
      stage_w(k + 1, (k + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t wbase = ws_u + (k & 1) * w_items * 16 + a_lane;
    const uint32_t xbase = xs_u + k * 16;
#pragma unroll 4
    for (int kk = 0; kk < chunks / 2; ++kk)
      warp_step(acc, wbase + kk * 2 * BM * 16, 16 * 16, xbase + kk * 2 * ROWS * 16 + b_lane[0],
                xbase + kk * 2 * ROWS * 16 + b_lane[1]);
    __syncthreads();  // before the next tap's copy reuses this buffer
  }

  // acc[mi][ni][2h + j]: output channel wm*32 + mi*16 + lane/4 + 8h, position
  // wn*32 + ni*8 + 2*(lane%4) + j
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
      float* row = out + ((long long)n * Cfi + q) * T + t0 + wn * 32 + 2 * (lane & 3);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        *reinterpret_cast<float2*>(row + ni * 8) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    }
}

// The data gradient of a forward conv with weights w [3, Cfo, Cfi] over dy
// [N, Cfo, T]: out [N, Cfi, T] float. wp holds 3*Cfo*Cfi bf16.
inline int data_grad(const float* dy, const void* w, float* out, int N, int Cfo, int Cfi, int T, bf16* wp,
                     cudaStream_t st) {
  if (Cfo % 16 || Cfi % BM || T % BN) return (int)cudaErrorInvalidValue;
  const int n = 3 * Cfo * Cfi;
  pack_dgrad_kernel<<<blocks_for(n, 256), 256, 0, st>>>(static_cast<const bf16*>(w), Cfo, Cfi, wp);
  DTR_TRY(cudaGetLastError());
  const int bytes = dgrad_smem_bytes(Cfo);
  // every launch: a cache in a static would be one object for every library
  // that includes this header (the dynamic linker unifies it)
  DTR_TRY(cudaFuncSetAttribute(dgrad_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  dgrad_kernel_tc<<<dim3(N * T / BN, Cfi / BM), THREADS, bytes, st>>>(dy, wp, out, Cfo, Cfi, T);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- weight gradients
__device__ __forceinline__ uint4 pack8_bf16(const bf16 (&v)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    w[h] = (uint32_t)__bfloat16_as_ushort(v[2 * h]) | ((uint32_t)__bfloat16_as_ushort(v[2 * h + 1]) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct DwArgs {
  const float* dy;  // [N, Cout, T]
  View<bf16> x;     // the conv's input before any upsampling, Tx steps a row
  int Cout, Cin, T, Tx, N;
  int up;           // x is upsampled: rows are (phase, o), dy read at 2m + phase, x's halo clamped
  int per;          // positions (of Tx per sample) per range, a multiple of BP
  float* part;      // [range][(up ? 2 : 1) * Cout][Cin * 3]
  float* bias_part; // [range][(up ? 2 : 1) * Cout]: sums of the unrounded dy, the bias gradient's partials
};

// dynamic shared memory: dy [BP/8][BM][8] and x [BN/8][ROWS][8], each twice;
// afterwards the same bytes hold the block's float sums [BM][BN*3]; then the
// bias sums of the four thread quarters [4][BM]
constexpr int DW_DY_ITEMS = BP / 8 * BM;
constexpr int DW_X_ITEMS = BN / 8 * ROWS;
constexpr int DW_SUMS = (2 * (DW_DY_ITEMS + DW_X_ITEMS) * 16 > BM * BN * 3 * 4) ? 2 * (DW_DY_ITEMS + DW_X_ITEMS) * 16
                                                                               : BM * BN * 3 * 4;
constexpr int DW_SMEM = DW_SUMS + DW_THREADS * 4;

// grid: (Cin/BN, rows/BM, ranges). See the header comment. The blocks of
// the first input-channel tile also sum the unrounded dy of their rows (the
// conv's bias gradient), each thread over its own items in a fixed order.
__global__ void __launch_bounds__(DW_THREADS, 2) dw_kernel_tc(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wi = warp & 3;
  constexpr int DY_Q = DW_DY_ITEMS / DW_THREADS;                   // 2
  constexpr int X_Q = (DW_X_ITEMS + DW_THREADS - 1) / DW_THREADS;  // 3
  uint4* dys[2] = {reinterpret_cast<uint4*>(smem), reinterpret_cast<uint4*>(smem) + DW_DY_ITEMS};
  uint4* xs[2] = {reinterpret_cast<uint4*>(smem) + 2 * DW_DY_ITEMS,
                  reinterpret_cast<uint4*>(smem) + 2 * DW_DY_ITEMS + DW_X_ITEMS};
  const int i0 = blockIdx.x * BN;
  const int oc0 = blockIdx.y * BM;
  const int phase = a.up ? oc0 / a.Cout : 0, o0 = oc0 - phase * a.Cout;
  const int ts = a.up ? 2 : 1;
  const int P = a.N * a.Tx;
  const int lo = blockIdx.z * a.per, hi = min(P, lo + a.per);
  const bool bias = blockIdx.x == 0;
  float bsum = 0.f;

  // staging in registers: dy items (o = e % BM, 8 positions of chunk e / BM),
  // x items (channel chunk, row); every chunk of BP positions lies in one
  // sample and in the range
  float dv[DY_Q][8];
  bf16 xv[X_Q][8];
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto load = [&](int q0) {
    const int n = q0 / a.Tx, m0 = q0 - n * a.Tx;
#pragma unroll
    for (int q = 0; q < DY_Q; ++q) {
      const int e = tid + q * DW_THREADS, o = e % BM, pc = e / BM;
      const float* d = a.dy + ((long long)n * a.Cout + o0 + o) * a.T + (long long)(m0 + pc * 8) * ts;
      if (ts == 1) {
        const float4 u = *reinterpret_cast<const float4*>(d), v = *reinterpret_cast<const float4*>(d + 4);
        dv[q][0] = u.x, dv[q][1] = u.y, dv[q][2] = u.z, dv[q][3] = u.w;
        dv[q][4] = v.x, dv[q][5] = v.y, dv[q][6] = v.z, dv[q][7] = v.w;
      } else {
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float4 u = *reinterpret_cast<const float4*>(d + 4 * h);
          dv[q][2 * h] = phase ? u.y : u.x;
          dv[q][2 * h + 1] = phase ? u.w : u.z;
        }
      }
      if (bias)
#pragma unroll
        for (int j = 0; j < 8; ++j) bsum += dv[q][j];
    }
#pragma unroll
    for (int q = 0; q < X_Q; ++q) {
      const int e = tid + q * DW_THREADS;
      const int c = e / ROWS;
      int ti = m0 - 1 + (e - c * ROWS);
      bool in = e < DW_X_ITEMS;
      if (a.up)
        ti = min(max(ti, 0), a.Tx - 1);
      else
        in = in && ti >= 0 && ti < a.Tx;
      const bf16* src = a.x.row(n, i0 + (in ? c : 0) * 8) + (in ? ti : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[q][j] = in ? src[(long long)j * a.x.sC] : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < DY_Q; ++q) dys[buf][tid + q * DW_THREADS] = pack8(dv[q]);
#pragma unroll
    for (int q = 0; q < X_Q; ++q) {
      const int e = tid + q * DW_THREADS;
      if (e < DW_X_ITEMS) xs[buf][e] = pack8_bf16(xv[q]);
    }
  };

  float acc[3][2][2][4];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[k][mi][ni][r] = 0.f;

  // per lane: the A row (dy) and the B row (x, ldmatrix.trans: matrices
  // (positions 0-7 | 8-15) x (channel chunk 2wi | 2wi + 1))
  const uint32_t a_lane = ((lane >> 4) * BM + wm * 32 + (lane & 15)) * 16;
  const uint32_t b_lane = ((2 * wi + (lane >> 4)) * ROWS + ((lane >> 3) & 1) * 8 + (lane & 7)) * 16;

  int buf = 0;
  if (lo < hi) {
    load(lo);
    store(0);
  }
  __syncthreads();
  for (int q0 = lo; q0 < hi; q0 += BP) {
    const bool more = q0 + BP < hi;
    if (more) load(q0 + BP);  // in registers while the products run
    const uint32_t abase = smem_u32(dys[buf]) + a_lane, bbase = smem_u32(xs[buf]) + b_lane;
#pragma unroll
    for (int kk = 0; kk < BP / 16; ++kk) {
      uint32_t af[2][4];
      ldmatrix_x4(af[0], abase + kk * 2 * BM * 16);
      ldmatrix_x4(af[1], abase + kk * 2 * BM * 16 + 16 * 16);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, bbase + (kk * 16 + k) * 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma(acc[k][mi][0], af[mi], bf[0], bf[1]);
          mma(acc[k][mi][1], af[mi], bf[2], bf[3]);
        }
      }
    }
    if (more) store(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }

  // acc[k][mi][ni][2h + j]: row wm*32 + mi*16 + lane/4 + 8h, input channel
  // wi*16 + ni*8 + 2*(lane%4) + j. The tile's (i, k) are one contiguous run
  // of BN*3 partials per row: gather them, then write whole rows.
  float* sums = reinterpret_cast<float*>(smem);
  constexpr int ROW = BN * 3;
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int o = wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
            const int i = wi * 16 + ni * 8 + 2 * (lane & 3) + j;
            sums[o * ROW + i * 3 + k] = acc[k][mi][ni][2 * h + j];
          }
  float* bred = reinterpret_cast<float*>(smem + DW_SUMS);  // [tid / BM][tid % BM]: row tid % BM
  bred[tid] = bsum;
  __syncthreads();
  if (bias && tid < BM)
    a.bias_part[(long long)blockIdx.z * gridDim.y * BM + oc0 + tid] =
        bred[tid] + bred[BM + tid] + bred[2 * BM + tid] + bred[3 * BM + tid];
  const int R = a.Cin * 3;
  float* part = a.part + (long long)blockIdx.z * gridDim.y * BM * R + (long long)oc0 * R + i0 * 3;
  for (int e = tid; e < BM * ROW; e += DW_THREADS) {
    const int o = e / ROW, r = e - o * ROW;
    part[(long long)o * R + r] = sums[e];
  }
}

// The ends of the upsampled weight gradient's correction terms:
// dye[s][n][o] = bf16(dy[n, o, s ? T - 1 : 0]), xe[s][n][i] = x[n, i, s ? Tx - 1 : 0].
__global__ void up_edges_kernel(const float* __restrict__ dy, View<bf16> x, int N, int Cout, int Cin, int T,
                                int Tx, float* __restrict__ dye, float* __restrict__ xe) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int nd = 2 * N * Cout, nx = 2 * N * Cin;
  if (e < nd) {
    const int s = e / (N * Cout), r = e - s * N * Cout, n = r / Cout, o = r - n * Cout;
    dye[e] = round_s<bf16>(dy[((long long)n * Cout + o) * T + (s ? T - 1 : 0)]);
  } else if (e < nd + nx) {
    const int f = e - nd;
    const int s = f / (N * Cin), r = f - s * N * Cin, n = r / Cin, i = r - n * Cin;
    xe[f] = ld(x.row(n, i) + (s ? Tx - 1 : 0));
  }
}

// Adds the ranges' partials of both phases in order, applies up2's weights
// and the end corrections (header comment), and writes the gradient
// tap-major: (o, i, k) at out[(k*Cout + o)*Cin + i].
__global__ void dw_reduce_up_kernel(const float* __restrict__ part, int ranges, int Cout, int Cin, int N,
                                    const float* __restrict__ dye, const float* __restrict__ xe,
                                    float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= Cout * Cin) return;
  const int o = e / Cin, i = e - o * Cin;
  const int R = Cin * 3;
  float S[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};  // S[phase][shift + 1]
  for (int z = 0; z < ranges; ++z)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* r = part + ((long long)(z * 2 + p) * Cout + o) * R + i * 3;
#pragma unroll
      for (int s = 0; s < 3; ++s) S[p][s] += r[s];
    }
  float first = 0.f, last = 0.f;
  for (int n = 0; n < N; ++n) {
    first = fmaf(dye[n * Cout + o], xe[n * Cin + i], first);
    last = fmaf(dye[(N + n) * Cout + o], xe[(N + n) * Cin + i], last);
  }
  out[(long long)o * Cin + i] = 0.75f * S[0][0] + 0.25f * S[0][1] + 0.75f * S[1][1] + 0.25f * S[1][0] - first;
  out[((long long)Cout + o) * Cin + i] = 0.75f * (S[0][1] + S[1][1]) + 0.25f * (S[0][0] + S[1][2]);
  out[(2LL * Cout + o) * Cin + i] = 0.75f * S[0][1] + 0.25f * S[0][2] + 0.75f * S[1][2] + 0.25f * S[1][1] - last;
}

// Positions per range of a weight gradient over P positions with `tiles`
// (o, i) tiles: from the shape alone, a multiple of BP.
inline int range_positions(int P, int tiles) {
  int ranges = blocks_for(TARGET_BLOCKS, tiles);
  ranges = ranges < MAX_RANGES ? ranges : MAX_RANGES;
  ranges = ranges < P / BP ? ranges : P / BP;
  return blocks_for(blocks_for(P, ranges), BP) * BP;
}

// Floats of the partials of one weight gradient.
inline long long part_floats(int Cout, int Cin, int Tx, int N, int up) {
  const int rows = (up ? 2 : 1) * Cout, P = N * Tx;
  const int per = range_positions(P, (Cin / BN) * (rows / BM));
  return (long long)blocks_for(P, per) * rows * Cin * 3;
}

// The weight and bias gradients of a forward conv (w [3, Cout, Cin]) over
// its output gradient dy [N, Cout, T] and its input x (up2(x), Tx = T/2
// steps, when up), the weight's written tap-major into out. part holds
// part_floats(...) floats, bias_part MAX_RANGES * 2 * Cout, edges
// 2*N*(Cout + Cin) (up only).
inline int weight_grad(const float* dy, const View<bf16>& x, int Cin, int Cout, int T, int N, int up, void* out,
                       void* bias_out, float* part, float* bias_part, float* edges, cudaStream_t st) {
  const int Tx = up ? T / 2 : T;
  if (Cin % BN || Cout % BM || Tx % BP) return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.dy = dy; a.x = x; a.Cout = Cout; a.Cin = Cin; a.T = T; a.Tx = Tx; a.N = N; a.up = up;
  a.part = part; a.bias_part = bias_part;
  const int phases = up ? 2 : 1, rows = phases * Cout, P = N * Tx;
  a.per = range_positions(P, (Cin / BN) * (rows / BM));
  const int ranges = blocks_for(P, a.per);
  DTR_TRY(cudaFuncSetAttribute(dw_kernel_tc, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM));
  dw_kernel_tc<<<dim3(Cin / BN, rows / BM, ranges), DW_THREADS, DW_SMEM, st>>>(a);
  DTR_TRY(cudaGetLastError());
  bias_reduce_kernel<<<blocks_for(Cout, 4), 128, 0, st>>>(bias_part, ranges, phases, Cout,
                                                          static_cast<float*>(bias_out));
  DTR_TRY(cudaGetLastError());
  float* o = static_cast<float*>(out);
  if (!up) {
    dw_reduce_kernel<<<blocks_for((long long)Cout * Cin * 3, 256), 256, 0, st>>>(part, ranges, Cout, Cin, o);
    return (int)cudaGetLastError();
  }
  float* dye = edges;
  float* xe = edges + 2LL * N * Cout;
  up_edges_kernel<<<blocks_for(2LL * N * (Cout + Cin), 256), 256, 0, st>>>(dy, x, N, Cout, Cin, T, Tx, dye, xe);
  DTR_TRY(cudaGetLastError());
  dw_reduce_up_kernel<<<blocks_for((long long)Cout * Cin, 256), 256, 0, st>>>(part, ranges, Cout, Cin, N, dye,
                                                                              xe, o);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- forward convs
// wp[((c*3 + k)*Cout + o)*8 + j] = w[k, o, c*8 + j] from the forward's weights
// w [3, Cout, Cin]: one 16-byte A row per (input-channel chunk, tap, output
// channel), so a chunk of FK input channels holds every tap's rows.
__global__ void pack_fwd_tc_kernel(const bf16* __restrict__ w, int Cout, int Cin, bf16* __restrict__ wp) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * Cout * Cin) return;
  const int j = e & 7;
  int r = e >> 3;
  const int o = r % Cout;
  r /= Cout;
  const int k = r % 3, c = r / 3;
  wp[e] = w[((long long)k * Cout + o) * Cin + c * 8 + j];
}

constexpr int FK = 32;                       // input channels per streamed weight chunk
constexpr int FW_ITEMS = FK / 8 * 3 * BM;    // its 16-byte A rows: [FK/8][tap][BM]
constexpr int UP_ROWS = 72;                  // staged input rows of an upsampled conv: 9 n8 tiles
constexpr int UP_YST = 72;                   // floats per row of Y in shared memory

inline int fwd_smem_bytes(int up, int Cin) {
  const int stage = (Cin / 8) * (up ? UP_ROWS : ROWS) * 16 + 2 * FW_ITEMS * 16;
  const int ys = up ? 3 * BM * UP_YST * 4 : 0;
  return stage > ys ? stage : ys;
}

// A forward conv of one block: BM output channels over BN input positions
// t0 .. t0 + 63 of sample n (Tin steps a row; see the header comment).
// UP 0: out[n, o, t] = bias[o] + sum over (k, i) of w[k, o, i] * x[n, i, t + k - 1],
// x zero outside [0, Tin). UP 1: the same conv over up2(x), 2*Tin steps,
// from Y_k = W_k x at input resolution. grid: (N*Tin / BN, Cout / BM); out
// [N, Cout, T] float, T = Tin or 2*Tin; Cin a multiple of FK.
template <int UP>
__global__ void __launch_bounds__(THREADS) conv_fwd_kernel_tc(View<bf16> x, const bf16* __restrict__ wp,
                                                             const float* __restrict__ bias, float* __restrict__ out,
                                                             int Cin, int Cout, int Tin) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int XR = UP ? UP_ROWS : ROWS;
  const int chunks = Cin / 8;
  uint4* xs = reinterpret_cast<uint4*>(smem);  // [chunks][XR]: rows t0 - 1 .. t0 - 1 + XR - 1
  uint4* ws = xs + chunks * XR;                // [2][FW_ITEMS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * BN;
  const int n = p0 / Tin, t0 = p0 - n * Tin;
  const int o0 = blockIdx.y * BM;
  const uint4* wsrc = reinterpret_cast<const uint4*>(wp) + o0;
  auto stage_w = [&](int kc, int buf) {
    uint4* dst = ws + buf * FW_ITEMS;
    const uint4* src = wsrc + (long long)kc * (FK / 8) * 3 * Cout;
    for (int e = tid; e < FW_ITEMS; e += THREADS) {
      const int r = e / BM, o = e - r * BM;  // r = chunk * 3 + tap
      cp_async16(smem_u32(dst + e), src + (long long)r * Cout + o);
    }
    cp_async_commit();
  };
  stage_w(0, 0);

  // x's rows as channel chunks, X_BATCH rows of 8 channels per thread in
  // flight; an upsampled conv clamps its rows into the sample (up2's edge),
  // a plain one reads zeros outside it (the conv's padding)
  const bf16 zero = __float2bfloat16_rn(0.f);
  const int x_items = chunks * XR;
  for (int e0 = tid; e0 < x_items; e0 += X_BATCH * THREADS) {
    bf16 v[X_BATCH][8];
#pragma unroll
    for (int u = 0; u < X_BATCH; ++u) {
      const int e = e0 + u * THREADS;
      const int c = e / XR;
      int t = t0 - 1 + (e - c * XR);
      bool in = e < x_items;
      if (UP)
        t = min(max(t, 0), Tin - 1);
      else
        in = in && t >= 0 && t < Tin;
      const bf16* src = x.row(n, (in ? c : 0) * 8) + (in ? t : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[u][j] = in ? src[(long long)j * x.sC] : zero;
    }
#pragma unroll
    for (int u = 0; u < X_BATCH; ++u)
      if (e0 + u * THREADS < x_items) xs[e0 + u * THREADS] = pack8_bf16(v[u]);
  }

  const uint32_t xs_u = smem_u32(xs), ws_u = smem_u32(ws);
  const int nk = Cin / FK;
  auto next_chunk = [&](int kc) {
    if (kc + 1 < nk) {
      stage_w(kc + 1, (kc + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  if constexpr (UP) {
    // warp w: output channels 16w .. 16w + 15 for all three taps, over the
    // 9 n8 tiles of staged rows; acc[k][j][2h + i]: channel 16w + lane/4 + 8h,
    // row 8j + 2*(lane%4) + i, i.e. Y_k at u = t0 - 1 + row
    float acc[3][9][4];
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[k][j][r] = 0.f;
    const uint32_t a_lane = ((lane >> 4) * 3 * BM + 16 * warp + (lane & 15)) * 16;
    const uint32_t b_lane = (((lane >> 3) & 1) * XR + ((lane >> 4) << 3) + (lane & 7)) * 16;
    for (int kc = 0; kc < nk; ++kc) {
      next_chunk(kc);
      const uint32_t wbase = ws_u + (kc & 1) * FW_ITEMS * 16 + a_lane;
#pragma unroll
      for (int s = 0; s < FK / 16; ++s) {
        uint32_t a[3][4];
#pragma unroll
        for (int k = 0; k < 3; ++k) ldmatrix_x4(a[k], wbase + (2 * s * 3 + k) * BM * 16);
        const uint32_t xbase = xs_u + (kc * (FK / 8) + 2 * s) * XR * 16 + b_lane;
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, xbase + jp * 16 * 16);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            mma(acc[k][2 * jp], a[k], b[0], b[1]);
            mma(acc[k][2 * jp + 1], a[k], b[2], b[3]);
          }
        }
        uint32_t b[2];
        ldmatrix_x2(b, xbase + 64 * 16);
#pragma unroll
        for (int k = 0; k < 3; ++k) mma(acc[k][8], a[k], b[0], b[1]);
      }
      __syncthreads();  // before the next chunk's copy reuses this buffer
    }

    // Y [3][BM][UP_YST] float over the staging buffers, then each output
    // step from its up2 terms in float32: up2(y)[2m] = .25 y[m - 1] + .75 y[m],
    // up2(y)[2m + 1] = .75 y[m] + .25 y[m + 1] (the clamp is in the staged
    // rows), a tap that falls on the conv's padding (outside [0, 2*Tin))
    // left out
    float* ys = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int k = 0; k < 3; ++k)
#pragma unroll
      for (int j = 0; j < 9; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int o = 16 * warp + (lane >> 2) + 8 * h;
          *reinterpret_cast<float2*>(ys + (k * BM + o) * UP_YST + 8 * j + 2 * (lane & 3)) =
              make_float2(acc[k][j][2 * h], acc[k][j][2 * h + 1]);
        }
    __syncthreads();
    const int T = 2 * Tin;
    for (int e = tid; e < BM * (2 * BN / 4); e += THREADS) {
      const int o = e / (2 * BN / 4), q = e - o * (2 * BN / 4);
      const float b = bias[o0 + o];
      float v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d0 = 4 * q + i - 1;  // tap 0's up2 step, relative to 2*t0
        float sum = 0.f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const int d = d0 + k, s = 2 * t0 + d;
          if (s < 0 || s >= T) continue;
          const float* y = ys + (k * BM + o) * UP_YST + (d >> 1) + 1;  // Y_k at u = t0 + floor(d / 2)
          sum += (d & 1) ? 0.75f * y[0] + 0.25f * y[1] : 0.25f * y[-1] + 0.75f * y[0];
        }
        v[i] = sum + b;
      }
      *reinterpret_cast<float4*>(out + ((long long)n * Cout + o0 + o) * T + 2 * t0 + 4 * q) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    // four warps of 32 x 32 as the data gradient's; tap k is row offset k
    const int wm = warp >> 1, wn = warp & 1;
    float acc[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;
    const uint32_t a_lane = ((lane >> 4) * 3 * BM + wm * 32 + (lane & 15)) * 16;
    uint32_t b_lane[2];
#pragma unroll
    for (int nj = 0; nj < 2; ++nj)
      b_lane[nj] = (((lane >> 3) & 1) * XR + wn * 32 + nj * 16 + ((lane >> 4) << 3) + (lane & 7)) * 16;
    for (int kc = 0; kc < nk; ++kc) {
      next_chunk(kc);
      const uint32_t wbase = ws_u + (kc & 1) * FW_ITEMS * 16 + a_lane;
#pragma unroll
      for (int s = 0; s < FK / 16; ++s) {
        const uint32_t xbase = xs_u + (kc * (FK / 8) + 2 * s) * XR * 16;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          warp_step(acc, wbase + (2 * s * 3 + k) * BM * 16, 16 * 16, xbase + k * 16 + b_lane[0],
                    xbase + k * 16 + b_lane[1]);
      }
      __syncthreads();  // before the next chunk's copy reuses this buffer
    }
    // acc[mi][ni][2h + j]: output channel wm*32 + mi*16 + lane/4 + 8h,
    // position wn*32 + ni*8 + 2*(lane%4) + j
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = o0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
        const float b = bias[o];
        float* row = out + ((long long)n * Cout + o) * Tin + t0 + wn * 32 + 2 * (lane & 3);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(row + ni * 8) = make_float2(acc[mi][ni][2 * h] + b, acc[mi][ni][2 * h + 1] + b);
      }
  }
}

// A forward conv with weights w [3, Cout, Cin] (bf16) and bias [Cout]
// (float) over x, Tin steps a row: out [N, Cout, T] float, T = Tin, or
// 2*Tin over up2(x) when UP. wp holds 3*Cout*Cin bf16.
template <int UP>
inline int forward_conv(const View<bf16>& x, const void* w, const void* bias, float* out, int N, int Cin, int Cout,
                        int T, bf16* wp, cudaStream_t st) {
  const int Tin = UP ? T / 2 : T;
  if (Cin % FK || Cout % BM || Tin % BN) return (int)cudaErrorInvalidValue;
  pack_fwd_tc_kernel<<<blocks_for(3LL * Cout * Cin, 256), 256, 0, st>>>(static_cast<const bf16*>(w), Cout, Cin, wp);
  DTR_TRY(cudaGetLastError());
  const int bytes = fwd_smem_bytes(UP, Cin);
  DTR_TRY(cudaFuncSetAttribute(conv_fwd_kernel_tc<UP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  conv_fwd_kernel_tc<UP><<<dim3(N * Tin / BN, Cout / BM), THREADS, bytes, st>>>(
      x, wp, static_cast<const float*>(bias), out, Cin, Cout, Tin);
  return (int)cudaGetLastError();
}

}  // namespace tc
}  // namespace dtr
