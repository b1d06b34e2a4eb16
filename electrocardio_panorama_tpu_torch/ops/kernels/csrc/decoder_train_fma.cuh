// The float32 FMA engine of the fused train decoder (A4f, decoder_train_fwd.cu,
// and A4b, decoder_train_bwd.cu) for Hopper, sm_90a: the forward convs, the
// data gradients and the weight gradients of conv1..conv4 as plain FMA at full
// float32 (no TF32, no tensor cores), the conv biases' gradients riding in the
// weight-gradient blocks. The bfloat16 instantiations run the forward convs
// and the backward's products on decoder_train_tc.cuh; conv5, BatchNorm (moments, normalisation, backward),
// the sigmoid and the up2 adjoints stay SIMT in both.
//
// Replaces, with those, the TPU kernels
// electrocardio_panorama_tpu/ops/pallas/decoder_train.py::_train_fwd_kernel and
// ::_train_bwd_kernel.
//
// Tap convs (tap_tile): out[n, i, t] = sum over (k, o) of w[2 - k, o, i] *
// in[n, o, t + k - 1]. A data gradient (dgrad_kernel_fma) is that sum over dy
// with the forward's weights w [3, Cfo, Cfi], which are [tap][o][i] already,
// so the flip is an index and no packing launch is needed. A forward conv
// a[n, o, t] = b[o] + sum over (k, i) of w[k, o, i] * x[n, i, t + k - 1]
// (conv_fwd_kernel_fma) is the same sum over x with its weights packed once per
// launch as wt[k'][i][o] = w[2 - k'][o][i] (pack_fwd_kernel), and b added in the
// store. A block takes 64 output channels x 64 positions of one sample (T is a
// multiple of 64, so a tile never crosses a sample) with two groups of 64
// threads, each taking half of every chunk of 16 summed channels; a thread
// holds 8 channels x 8 positions. Per chunk the input's rows t0 - 4 .. t0 + 67
// are staged once (zero outside the sample), so a tap is an offset into a
// staged row, and the chunk's weights for the three taps beside them; both are
// 16-byte cp.async copies into a double buffer. Per summed channel a thread
// reads its positions' taps with 6 float4 loads and per tap 8 weights with two
// float4 loads (broadcast across the positions' threads), for 192 FMAs. The
// groups' sums meet in shared memory (group 0's plus group 1's, a fixed order)
// and leave as float4 rows of the float plane [N, C, T]. The forward's
// upsampled convs run over up2(x) and up2(h2) materialized per launch by
// up2_plane_kernel (up2_at's values, those the plain version's upsample
// gives), so only the order of the float32 sums differs from the plain
// version.
//
// Weight gradients (dw_kernel_fma): dW_k[o][i] = sum_p dy[o][p] *
// X[i][p + k - 1] over one of a fixed set of position ranges, p = (n, t), X
// the conv's input plane [N, Cin, T]; up2(h2) and up2(x) of the upsampled
// convs are materialized once per launch (up2_plane_kernel: up2_at's
// values). A block takes a 64 (o) x 32 (i) tile
// for all three taps with four groups of 64 threads. Per chunk of 64
// positions (inside one sample) dy is staged as [o][p] and X as [i][row] with
// the taps' halo, and group g walks the chunk's segment g (16 positions) with
// its X rows in a register ring, so each X value is read once for all three
// taps and one dy value serves 3 x 4 FMAs: a thread holds 8 o x 4 i x 3 taps
// = 96 accumulators. The groups' sums meet in shared memory in a fixed order
// and leave as whole rows of partials; dw_reduce_kernel adds the ranges in a
// fixed order and writes the tap-major gradient. The ranges are whole chunks and depend on the shape
// alone (TARGET_BLOCKS per layer), and there are no atomics, so a repeat
// launch gives the same bits. The conv's bias gradient, the sum of dy, rides
// along: the blocks of the first i-tile sum the dy they stage (each group
// its segment, the groups in order), and bias_reduce_kernel adds the ranges.
//
// Bound. At 3 groups of 32 the backward's eight products are 21.8 GFLOP,
// 0.325 ms at the 67 TFLOP/s float32 FMA peak of an H100, against about 0.1 GB
// of kept planes, dout and gradients (0.03 ms at 3.35 TB/s), and the forward's
// four convs 10.9 GFLOP, 0.163 ms: operations bound both. The register tiles
// keep the FMA pipes, not the shared-memory loads, the limit of the main loops
// (12 float4 loads per 192 FMAs in a tap conv, 12 scalar loads per 96 in a
// weight gradient).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "decoder_train_common.cuh"
#include "tc_ptx.cuh"

namespace dtr {
namespace fma {

using namespace tcptx;  // cp.async

constexpr int HALO = 4;  // staged steps before a chunk's first position (16-byte aligned)

// a row stride of 4k floats with k odd: the rows a warp reads at one step
// fall on distinct banks
constexpr int odd4(int n) { return (n / 4) % 2 ? n : n + 4; }

// --------------------------------- tap convs: data gradients, forward convs
constexpr int BM = 64;                   // channels i per block
constexpr int BN = 64;                   // positions per block
constexpr int O_T = 16;                  // channels o per staged chunk
constexpr int GROUPS = 2;                // groups of 8 x 8 threads, each taking O_T / 2 of every chunk
constexpr int THREADS = 64 * GROUPS;
constexpr int ROWS = BN + 2 * HALO;      // staged dy steps per channel o
constexpr int XF = O_T * ROWS;           // floats of staged dy per buffer
constexpr int WF = 3 * O_T * BM;         // floats of staged weights per buffer
constexpr int DG_FLOATS = 2 * (XF + WF);  // 33,792 bytes, static

// The tap conv of one block (see the header comment), plus bias[i] when BIAS.
// grid: (N*T / BN, Cfi / BM); dy [N, Cfo, T], w [3, Cfo, Cfi], bias [Cfi],
// out [N, Cfi, T]; T a multiple of BN, Cfo of O_T, Cfi of BM.
template <bool BIAS>
__device__ __forceinline__ void tap_tile(const float* __restrict__ dy, const float* __restrict__ w,
                                         const float* __restrict__ bias, float* __restrict__ out, int Cfo,
                                         int Cfi, int T) {
  __shared__ __align__(16) float smem[DG_FLOATS];
  const int tid = threadIdx.x, tx = tid & 7, ty = (tid >> 3) & 7, grp = tid >> 6;
  const int p0 = blockIdx.x * BN;
  const int n = p0 / T, t0 = p0 - n * T;
  const int i0 = blockIdx.y * BM;
  const float* dyn = dy + (long long)n * Cfo * T;
  // buffer b: dy rows [O_T][ROWS], then weights [3][O_T][BM]
  auto xs = [&](int b) { return smem + b * (XF + WF); };
  auto ws = [&](int b) { return smem + b * (XF + WF) + XF; };

  // chunk ch: channels o0 .. o0 + O_T - 1; tap k's weights are w[2 - k]
  auto stage = [&](int ch, int b) {
    const int o0 = ch * O_T;
    for (int e = tid; e < 3 * O_T * (BM / 4); e += THREADS) {
      const int row = e / (BM / 4), c4 = e - row * (BM / 4);  // row = k*O_T + o
      const int k = row / O_T, o = row - k * O_T;
      cp_async16(smem_u32(ws(b) + row * BM + 4 * c4), w + ((long long)(2 - k) * Cfo + o0 + o) * Cfi + i0 + 4 * c4);
    }
    for (int e = tid; e < O_T * (ROWS / 4); e += THREADS) {
      const int o = e / (ROWS / 4), r4 = e - o * (ROWS / 4);
      const int t = t0 - HALO + 4 * r4;
      const bool in = t >= 0 && t < T;
      cp_async16(smem_u32(xs(b) + o * ROWS + 4 * r4), dyn + (long long)(o0 + o) * T + (in ? t : 0), in);
    }
    cp_async_commit();
  };

  // acc[h][j][i]: channel i0 + 8ty + j, position t0 + 32h + 4tx + i
  float acc[2][8][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[h][j][i] = 0.f;

  const int chunks = Cfo / O_T;
  stage(0, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch + 1 < chunks) {
      stage(ch + 1, (ch + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* x = xs(ch & 1) + 4 * tx;
    const float* wt = ws(ch & 1) + 8 * ty;
#pragma unroll 2
    for (int o = grp * (O_T / GROUPS); o < (grp + 1) * (O_T / GROUPS); ++o) {
      // xv[h][m]: staged step 32h + 4tx + m; tap k of position i is m = i + k + HALO - 1
      float xv[2][12];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int v = 0; v < 3; ++v) {
          const float4 q = *reinterpret_cast<const float4*>(x + o * ROWS + 32 * h + 4 * v);
          xv[h][4 * v] = q.x, xv[h][4 * v + 1] = q.y, xv[h][4 * v + 2] = q.z, xv[h][4 * v + 3] = q.w;
        }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float4 w0 = *reinterpret_cast<const float4*>(wt + (k * O_T + o) * BM);
        const float4 w1 = *reinterpret_cast<const float4*>(wt + (k * O_T + o) * BM + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[h][j][i] = fmaf(wv[j], xv[h][i + k + HALO - 1], acc[h][j][i]);
      }
    }
    __syncthreads();  // before the next chunk's copy reuses this buffer
  }

  // group 1's sums into shared memory; group 0 adds them to its own and
  // writes the rows
  float* tile = smem;  // [BM][BN]
  if (grp == 1)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float4*>(tile + (8 * ty + j) * BN + 32 * h + 4 * tx) =
            make_float4(acc[h][j][0], acc[h][j][1], acc[h][j][2], acc[h][j][3]);
  __syncthreads();
  if (grp == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 u = *reinterpret_cast<const float4*>(tile + (8 * ty + j) * BN + 32 * h + 4 * tx);
        float4 v = make_float4(acc[h][j][0] + u.x, acc[h][j][1] + u.y, acc[h][j][2] + u.z, acc[h][j][3] + u.w);
        if (BIAS) {
          const float b = bias[i0 + 8 * ty + j];
          v = make_float4(v.x + b, v.y + b, v.z + b, v.w + b);
        }
        *reinterpret_cast<float4*>(out + ((long long)n * Cfi + i0 + 8 * ty + j) * T + t0 + 32 * h + 4 * tx) = v;
      }
}

__global__ void __launch_bounds__(THREADS, 3) dgrad_kernel_fma(const float* __restrict__ dy,
                                                             const float* __restrict__ w,
                                                             float* __restrict__ out, int Cfo, int Cfi, int T) {
  tap_tile<false>(dy, w, nullptr, out, Cfo, Cfi, T);
}

// a [N, Cout, T] = bias + conv3(x; w) over x [N, Cin, T], wt the packed
// weights [3][Cin][Cout] (pack_fwd_kernel). grid: (N*T / BN, Cout / BM).
__global__ void __launch_bounds__(THREADS, 3) conv_fwd_kernel_fma(const float* __restrict__ x,
                                                                const float* __restrict__ wt,
                                                                const float* __restrict__ bias,
                                                                float* __restrict__ a, int Cin, int Cout, int T) {
  tap_tile<true>(x, wt, bias, a, Cin, Cout, T);
}

// wt[k'][i][o] = w[2 - k'][o][i] for a forward conv's weights w [3, Cout, Cin].
__global__ void pack_fwd_kernel(const float* __restrict__ w, float* __restrict__ wt, int Cout, int Cin) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= 3 * Cout * Cin) return;
  const int o = e % Cout, i = (e / Cout) % Cin, k = e / (Cout * Cin);
  wt[e] = w[((2 - k) * Cout + o) * Cin + i];
}

// The data gradient of a forward conv with weights w [3, Cfo, Cfi] over dy
// [N, Cfo, T]: out [N, Cfi, T].
inline int data_grad(const float* dy, const float* w, float* out, int N, int Cfo, int Cfi, int T, cudaStream_t st) {
  if (T % BN || Cfo % O_T || Cfi % BM) return (int)cudaErrorInvalidValue;
  dgrad_kernel_fma<<<dim3(N * T / BN, Cfi / BM), THREADS, 0, st>>>(dy, w, out, Cfo, Cfi, T);
  return (int)cudaGetLastError();
}

// A forward conv with weights w [3, Cout, Cin] and bias [Cout] over the plane
// x [N, Cin, T]: a [N, Cout, T], float. wt holds 3*Cout*Cin floats for the
// packed weights.
inline int forward_conv(const float* x, const float* w, const float* bias, float* wt, float* a, int N, int Cin,
                        int Cout, int T, cudaStream_t st) {
  if (T % BN || Cin % O_T || Cout % BM) return (int)cudaErrorInvalidValue;
  pack_fwd_kernel<<<blocks_for(3LL * Cout * Cin, 256), 256, 0, st>>>(w, wt, Cout, Cin);
  DTR_TRY(cudaGetLastError());
  conv_fwd_kernel_fma<<<dim3(N * T / BN, Cout / BM), THREADS, 0, st>>>(x, wt, bias, a, Cin, Cout, T);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------- weight gradients
constexpr int SEG = 16;                  // positions a group walks per chunk
constexpr int DW_GROUPS = 4;             // groups of 8 (o) x 8 (i) threads; group g walks segment g of a chunk
constexpr int DW_THREADS = 64 * DW_GROUPS;
constexpr int DP = SEG * DW_GROUPS;      // positions per staged chunk; ranges are whole chunks
constexpr int OT = 8, IT = 4;            // a thread's o x i tile (channels og + 8j, ig + 8j), for all three taps
constexpr int BO = 8 * OT, BI = 8 * IT;  // the block's (o, i) tile
constexpr int XR = DP + 2 * HALO;        // staged X steps per input channel
constexpr int XST = odd4(XR);            // floats per staged input channel
constexpr int DST = odd4(DP);            // floats per staged output channel
constexpr int DW_BUF = BI * XST + BO * DST;  // floats per buffer
constexpr int ROW = BI * 3;              // a block's partials per output channel: (i, k) with i-major
constexpr int SROW = ROW + 8;            // their row stride in shared memory (the groups' stores spread over banks)
constexpr int DW_SMEM = 4 * (2 * DW_BUF + DW_GROUPS * BO);  // two buffers (later the sums), the bias sums
static_assert(2 * BO * SROW <= 2 * DW_BUF, "the block's two slices of sums fit the staging buffers");
// blocks per weight gradient: four waves of 132 SMs at the one block per SM
// that the kernel's 254 registers leave (on an H100 at 3 groups of 32, 264 and
// 132 blocks left SMs idle at the ends, 0.39 and 0.49 ms for the four layers
// against 0.35, and 1056 cost twice the partials, 0.40 ms)
constexpr int TARGET_BLOCKS = 4 * 132;

struct DwArgs {
  const float* dy;   // [N, Cout, T]
  const float* x;    // [N, Cin, T]
  int Cout, Cin, T;
  int chunks;        // N*T / DP
  int ranges;        // range z takes chunks [z*chunks/ranges, (z+1)*chunks/ranges)
  float* part;       // [range][Cout][Cin*3]
  float* bias_part;  // [range][Cout]: sums of dy, the bias gradient's partials
};

// grid: (Cin / BI, Cout / BO, ranges). See the header comment.
__global__ void __launch_bounds__(DW_THREADS) dw_kernel_fma(const DwArgs a) {
  extern __shared__ __align__(16) float smem_f[];
  const int tid = threadIdx.x, ig = tid & 7, og = (tid >> 3) & 7, grp = tid >> 6;
  const int i0 = blockIdx.x * BI, o0 = blockIdx.y * BO, z = blockIdx.z;
  const int c_lo = (int)((long long)z * a.chunks / a.ranges);
  const int c_hi = (int)((long long)(z + 1) * a.chunks / a.ranges);
  const bool bias = blockIdx.x == 0;

  // buffer b: X [BI][XST], then dy [BO][DST]
  auto xbuf = [&](int b) { return smem_f + b * DW_BUF; };
  auto dbuf = [&](int b) { return smem_f + b * DW_BUF + BI * XST; };
  auto stage = [&](int c, int b) {
    const int q = c * DP, n = q / a.T, t0 = q - n * a.T;
    const float* xn = a.x + ((long long)n * a.Cin + i0) * a.T;
    for (int e = tid; e < BI * (XR / 4); e += DW_THREADS) {
      const int i = e / (XR / 4), r4 = e - i * (XR / 4);
      const int t = t0 - HALO + 4 * r4;
      const bool in = t >= 0 && t < a.T;
      cp_async16(smem_u32(xbuf(b) + i * XST + 4 * r4), xn + (long long)i * a.T + (in ? t : 0), in);
    }
    const float* dn = a.dy + ((long long)n * a.Cout + o0) * a.T + t0;
    for (int e = tid; e < BO * (DP / 4); e += DW_THREADS) {
      const int o = e / (DP / 4), r4 = e - o * (DP / 4);
      cp_async16(smem_u32(dbuf(b) + o * DST + 4 * r4), dn + (long long)o * a.T + 4 * r4);
    }
    cp_async_commit();
  };

  float acc[3][OT][IT];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int jo = 0; jo < OT; ++jo)
#pragma unroll
      for (int ji = 0; ji < IT; ++ji) acc[k][jo][ji] = 0.f;
  float bsum = 0.f;  // first i-tile: the sum of dy row tid % BO over segment grp of every chunk

  int b = 0;
  if (c_lo < c_hi) stage(c_lo, 0);
  for (int c = c_lo; c < c_hi; ++c) {
    if (c + 1 < c_hi) {
      stage(c + 1, b ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // tap k of the segment's position tl reads X row tl + k of xr
    const float* xr = xbuf(b) + ig * XST + grp * SEG + HALO - 1;
    const float* dr = dbuf(b) + og * DST + grp * SEG;
    float ring[3][IT];  // ring[r % 3]: X row r
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int ji = 0; ji < IT; ++ji) ring[r][ji] = xr[8 * ji * XST + r];
#pragma unroll
    for (int tl = 0; tl < SEG; ++tl) {
#pragma unroll
      for (int ji = 0; ji < IT; ++ji) ring[(tl + 2) % 3][ji] = xr[8 * ji * XST + tl + 2];
      float d[OT];
#pragma unroll
      for (int jo = 0; jo < OT; ++jo) d[jo] = dr[8 * jo * DST + tl];
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int jo = 0; jo < OT; ++jo)
#pragma unroll
          for (int ji = 0; ji < IT; ++ji) acc[k][jo][ji] = fmaf(d[jo], ring[(tl + k) % 3][ji], acc[k][jo][ji]);
    }
    if (bias) {
      const float4* row = reinterpret_cast<const float4*>(dbuf(b) + (tid % BO) * DST + grp * SEG);
#pragma unroll
      for (int v = 0; v < SEG / 4; ++v) {
        const float4 u = row[v];
        bsum += u.x;
        bsum += u.y;
        bsum += u.z;
        bsum += u.w;
      }
    }
    __syncthreads();  // before the next chunk's copy reuses this buffer
    b ^= 1;
  }

  // the groups' sums, [o][i*3 + k], in two slices: groups 2 and 3 store
  // theirs, groups 0 and 1 add their own, and the rows leave as slice 0 plus
  // slice 1, (acc0 + acc2) + (acc1 + acc3) (a fixed order); the bias sums
  // beside them
  float* slice = smem_f + (grp & 1) * BO * SROW;
  float* bred = smem_f + 2 * DW_BUF;  // [grp][o]
#pragma unroll
  for (int q = 1; q >= 0; --q) {
    if ((grp >> 1) == q)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int jo = 0; jo < OT; ++jo)
#pragma unroll
          for (int ji = 0; ji < IT; ++ji) {
            float* s = slice + (og + 8 * jo) * SROW + (ig + 8 * ji) * 3 + k;
            *s = q == 0 ? acc[k][jo][ji] + *s : acc[k][jo][ji];
          }
    __syncthreads();
  }
  bred[tid] = bsum;
  __syncthreads();
  if (bias && tid < BO)
    a.bias_part[(long long)z * a.Cout + o0 + tid] = bred[tid] + bred[BO + tid] + bred[2 * BO + tid] + bred[3 * BO + tid];
  const int R = a.Cin * 3;
  float* part = a.part + ((long long)z * a.Cout + o0) * R + i0 * 3;
  for (int e = tid; e < BO * ROW; e += DW_THREADS) {
    const int o = e / ROW, r = e - o * ROW;
    part[(long long)o * R + r] = smem_f[o * SROW + r] + smem_f[(BO + o) * SROW + r];
  }
}

// out [N, C, T] = up2 of the rows of `in` (T / 2 steps each), per sample:
// the upsampled conv's input, up2_at's values.
// grid: (T / 1024, N*C), four steps a thread, one output row per blockIdx.y.
__global__ void up2_plane_kernel(View<float> in, float* __restrict__ out, int C, int T) {
  const int row = blockIdx.y, t = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (t >= T) return;
  const float* x = in.row(row / C, row % C);
  *reinterpret_cast<float4*>(out + (long long)row * T + t) =
      make_float4(up2_at<float, float>(x, t, T / 2), up2_at<float, float>(x, t + 1, T / 2),
                  up2_at<float, float>(x, t + 2, T / 2), up2_at<float, float>(x, t + 3, T / 2));
}

inline int up2_plane(const View<float>& in, float* out, int N, int C, int T, cudaStream_t st) {
  if (T % 4) return (int)cudaErrorInvalidValue;
  up2_plane_kernel<<<dim3(blocks_for(T, 1024), N * C), 256, 0, st>>>(in, out, C, T);
  return (int)cudaGetLastError();
}

// Position ranges of a weight gradient over N*T positions: TARGET_BLOCKS
// blocks over its (o, i) tiles, at most one range per chunk.
inline int dw_ranges(int Cout, int Cin, int T, int N) {
  const int tiles = (Cin / BI) * (Cout / BO), chunks = N * T / DP;
  const int r = blocks_for(TARGET_BLOCKS, tiles);
  return r < chunks ? r : chunks;
}

// Floats of the partials of one weight gradient, and of its bias sums.
inline long long part_floats(int Cout, int Cin, int T, int N) {
  return (long long)dw_ranges(Cout, Cin, T, N) * Cout * Cin * 3;
}
inline long long bias_part_floats(int Cout, int Cin, int T, int N) {
  return (long long)dw_ranges(Cout, Cin, T, N) * Cout;
}

// The weight and bias gradients of a forward conv (w [3, Cout, Cin]) over its
// output gradient dy [N, Cout, T] and its input plane x [N, Cin, T], the
// weight's written tap-major into out. part holds part_floats(...) floats,
// bias_part bias_part_floats(...).
inline int weight_grad(const float* dy, const float* x, int Cin, int Cout, int T, int N, void* out, void* bias_out,
                       float* part, float* bias_part, cudaStream_t st) {
  if (Cin % BI || Cout % BO || T % DP) return (int)cudaErrorInvalidValue;
  DwArgs a;
  a.dy = dy; a.x = x; a.Cout = Cout; a.Cin = Cin; a.T = T; a.chunks = N * T / DP;
  a.ranges = dw_ranges(Cout, Cin, T, N); a.part = part; a.bias_part = bias_part;
  DTR_TRY(cudaFuncSetAttribute(dw_kernel_fma, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM));
  dw_kernel_fma<<<dim3(Cin / BI, Cout / BO, a.ranges), DW_THREADS, DW_SMEM, st>>>(a);
  DTR_TRY(cudaGetLastError());
  bias_reduce_kernel<<<blocks_for(Cout, 4), 128, 0, st>>>(bias_part, a.ranges, 1, Cout, static_cast<float*>(bias_out));
  DTR_TRY(cudaGetLastError());
  dw_reduce_kernel<<<blocks_for((long long)Cout * Cin * 3, 256), 256, 0, st>>>(part, a.ranges, Cout, Cin,
                                                                              static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace fma
}  // namespace dtr
