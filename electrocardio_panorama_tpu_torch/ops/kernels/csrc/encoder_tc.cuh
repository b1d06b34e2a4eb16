// The bfloat16 tensor-core engine of the fused encoder (A2 forward,
// encoder_fwd.cu; A3 backward, encoder_bwd.cu) for Hopper, sm_90a: every
// grouped convolution whose input channels per group are a multiple of 16
// (all but conv1), and every weight gradient of those, as implicit GEMMs on
// `mma.sync.m16n8k16` bf16 products with float32 accumulators. The float32
// instantiation runs on the FMA engine of encoder_fma.cuh, and conv1 in both
// on the SIMT kernels of encoder_common.cuh and encoder_bwd.cu. Included by
// encoder_common.cuh after ConvArgs and conv_store, which it uses.
//
// Replaces, with the FMA engine and the SIMT kernels, the TPU kernels
// electrocardio_panorama_tpu/ops/pallas/encoder_fused.py::_fwd_kernel and
// ::_bwd_kernel.
//
// Layout. A block stages its input rows, with the taps' halo, as channel
// chunks [C/8][row][8] bf16: one time step of 8 channels is a 16-byte row, 8
// rows are one 8x8 matrix that `ldmatrix` reads, and a tap or a stride-2 step
// is only another row address per lane. Float gradient planes round to bf16
// (nearest even) as they are staged, where the SIMT kernel's round_s rounds
// them; a product of two bf16 values is exact in float32, so only the order
// of the float32 sums differs from the SIMT kernel.
//
// Convolutions (conv_kernel_tc): C[o][t] += W_k[o][i] * X[i][t*stride + k -
// pad] per tap k, 64 output channels x 64 output positions per block (one
// half sample at T=128, 2 or 4 whole samples at T=32 / 16), four warps of 32
// x 32. The block stages its input rows once, several rows per thread in
// flight. Weights are packed once per launch into [g][tap][C/8][o][8] bf16
// (pack_kernel; a data gradient's transposed, flipped weights are only other
// strides there) and streamed tap by tap with cp.async into a double buffer.
// The second operand c.b sums into its own accumulators; conv_store runs the
// epilogue that conv_kernel runs.
//
// Weight gradients (dw_kernel_tc): dW_k[o][i] = sum_p dy[o][p] * X[i][p + k -
// pad] over the positions of one of the fixed position ranges, a 64 x 64 tile
// of (o, i) for all K taps per block. Per chunk of 64 positions, dy is staged
// as [p/8][o][8] (rounded to bf16) and X with the taps' halo in the layout
// above; X reaches the tensor cores through ldmatrix.trans, so a tap is again
// a row offset, each X row is staged once for all taps and one dy fragment
// serves K products. The next chunk loads into registers while this one's
// products run. The block's partial sums leave through shared memory as
// whole rows; encoder_bwd.cu's dw_reduce_kernel adds the ranges in a fixed
// order: no atomics, so the gradients stay bitwise equal across repeats and
// encoder_ckpt modes.
//
// Bound. At B=32, L=3 the backward is about 58 GFLOP of products plus about
// 12 GFLOP of recompute against about 1 GB of float32 gradient planes and
// about 85 launches: 0.07 ms of operations at the bf16 peak, 0.3 ms of
// memory at 3.35 TB/s, plus the launch gaps. `mma.sync` at a modest 150
// TFLOP/s keeps the products near that floor; a tap shifts a reduction over
// time by one row, which per-lane ldmatrix addresses take for free and a
// wgmma descriptor cannot, so wgmma waits for a design whose products are
// the limit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_ptx.cuh"

namespace enc {
namespace tc {

using namespace tcptx;  // cp.async, ldmatrix, mma.sync, bf16 packing
using bf16 = __nv_bfloat16;

constexpr int BM = 64;       // output channels per block (conv and weight gradient)
constexpr int BN = 64;       // output positions (conv) or input channels of one tap (weight gradient) per block
constexpr int BP = 64;       // positions per staged chunk of a weight gradient
constexpr int THREADS = 128; // conv blocks: four warps, 2 x 2, each 32 x 32
constexpr int X_BATCH = 4;   // input rows a conv thread loads at once

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// ------------------------------------------------------------- weight packing
// out[((g*K + k)*cig/8 + c)*cog + o][j] = W(g, o, c*8 + j, k), from the
// operand's strides (a data gradient's are negative along k).
template <typename TI>
__global__ void pack_kernel(const Operand<bf16, TI> a, int cog, long long n, bf16* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int j = (int)(e & 7);
  long long r = e >> 3;
  const int o = (int)(r % cog);
  r /= cog;
  const int chunks = a.cig / 8;
  const int c = (int)(r % chunks);
  r /= chunks;
  const int k = (int)(r % a.K);
  const long long g = r / a.K;
  out[e] = a.w[g * a.wsG + o * a.wsO + (c * 8 + j) * a.wsI + k * a.wsK];
}

// ------------------------------------------------------------- conv engine
// Rows of one staged segment: steps output positions (a whole sample, or
// BN of one) need (steps - 1)*stride + K input rows.
struct Geometry {
  int steps, segs, rows, chunks;
  __host__ __device__ Geometry(int cig, int K, int stride, int Tout) {
    steps = Tout < BN ? Tout : BN;
    segs = BN / steps;
    rows = (steps - 1) * stride + K;
    chunks = cig / 8;
  }
  __host__ __device__ int x_bytes() const { return chunks * segs * rows * 16; }
};

// May this conv run on the engine? (every conv of the chain but conv1)
inline bool conv_ok(int cig, int cog, int Tout) {
  return cig % 16 == 0 && cog % BM == 0 && Tout % 16 == 0 && (Tout % BN == 0 || BN % Tout == 0);
}

// dynamic shared memory of a block: the larger operand's input rows and two
// taps of its weights
inline int conv_smem_bytes(const Geometry& ga, const Geometry* gb) {
  int x = ga.x_bytes(), c = ga.chunks;
  if (gb != nullptr) x = x > gb->x_bytes() ? x : gb->x_bytes(), c = c > gb->chunks ? c : gb->chunks;
  return x + 2 * c * BM * 16;
}

// acc += the conv of operand a over this block's positions, with its packed
// weights wp: the input rows staged once, the weights streamed tap by tap
// into a double buffer with cp.async.
template <typename TI>
__device__ __forceinline__ void conv_accumulate_tc(const Operand<bf16, TI>& a, const bf16* __restrict__ wp,
                                                   int cog, int g, int o0, int p0, int N, int Tout,
                                                   uint4* xs, uint4* ws, float (&acc)[2][4][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const Geometry geo(a.cig, a.K, a.stride, Tout);
  const int plane_rows = geo.segs * geo.rows;
  const uint4* wsrc = reinterpret_cast<const uint4*>(wp) + (long long)g * a.K * geo.chunks * cog + o0;
  const int w_items = geo.chunks * BM;
  auto stage_w = [&](int k, int buf) {
    uint4* dst = ws + buf * w_items;
    const uint4* src = wsrc + (long long)k * geo.chunks * cog;
    for (int e = tid; e < w_items; e += THREADS) {
      const int c = e / BM, o = e - c * BM;
      cp_async16(smem_u32(dst + e), src + (long long)c * cog + o);
    }
    cp_async_commit();
  };
  __syncthreads();  // the previous operand's tiles are consumed
  stage_w(0, 0);

  // the input rows of each segment: row r holds step t_lo*stride - pad + r;
  // X_BATCH rows of 8 channels per thread in flight at once
  const int x_items = geo.chunks * plane_rows;
  for (int e0 = tid; e0 < x_items; e0 += X_BATCH * THREADS) {
    float f[X_BATCH][8];
#pragma unroll
    for (int u = 0; u < X_BATCH; ++u) {
      const int e = e0 + u * THREADS;
      const int c = e / plane_rows, rr = e - c * plane_rows;
      const int s = rr / geo.rows, r = rr - s * geo.rows;
      const int ps = p0 + s * geo.steps;
      const int n = ps / Tout, ti = (ps - n * Tout) * a.stride - a.pad + r;
      const bool in = e < x_items && n < N && ti >= 0 && ti < a.xT;
      const TI* src = a.x + ((long long)n * a.xC + g * a.x_gs + a.x_off + c * 8) * a.xT + ti;
#pragma unroll
      for (int j = 0; j < 8; ++j) f[u][j] = in ? to_f(src[(long long)j * a.xT]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < X_BATCH; ++u)
      if (e0 + u * THREADS < x_items) xs[e0 + u * THREADS] = pack8(f[u]);
  }

  // per lane: the A row (weights) and the B rows (input) of its ldmatrix
  const uint32_t a_lane = ((lane >> 4) * BM + wm * 32 + (lane & 15)) * 16;
  uint32_t b_lane[2];
#pragma unroll
  for (int nj = 0; nj < 2; ++nj) {
    const int pos = wn * 32 + nj * 16 + ((lane >> 4) << 3) + (lane & 7);
    const int s = pos / geo.steps, tl = pos - s * geo.steps;
    b_lane[nj] = (((lane >> 3) & 1) * plane_rows + s * geo.rows + tl * a.stride) * 16;
  }
  const uint32_t xs_u = smem_u32(xs), ws_u = smem_u32(ws);

  for (int k = 0; k < a.K; ++k) {
    if (k + 1 < a.K) {
      stage_w(k + 1, (k + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t wbase = ws_u + (k & 1) * w_items * 16 + a_lane;
    const uint32_t xbase = xs_u + k * 16;
#pragma unroll 4
    for (int kk = 0; kk < geo.chunks / 2; ++kk)
      warp_step(acc, wbase + kk * 2 * BM * 16, 16 * 16, xbase + kk * 2 * plane_rows * 16 + b_lane[0],
                xbase + kk * 2 * plane_rows * 16 + b_lane[1]);
    __syncthreads();  // before the next tap's copy reuses this buffer
  }
}

// grid: (ceil(N*Tout / BN), G*cog / BM); conv_ok(...) holds for a and b.
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) conv_kernel_tc(const ConvArgs<bf16, TI, TO> c,
                                                         const bf16* __restrict__ wpa,
                                                         const bf16* __restrict__ wpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p0 = blockIdx.x * BN;
  const int oc0 = blockIdx.y * BM;
  const int g = oc0 / c.cog, o0 = oc0 - g * c.cog;
  const bool has_b = c.b.x != nullptr;
  const Geometry ga(c.a.cig, c.a.K, c.a.stride, c.Tout), gb(c.b.cig, c.b.K, c.b.stride, c.Tout);
  int xbytes = ga.x_bytes();
  if (has_b) xbytes = xbytes > gb.x_bytes() ? xbytes : gb.x_bytes();
  uint4* xs = reinterpret_cast<uint4*>(smem);
  uint4* ws = reinterpret_cast<uint4*>(smem + xbytes);

  float acc[2][4][4], acc2[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = acc2[mi][ni][r] = 0.f;
  conv_accumulate_tc<TI>(c.a, wpa, c.cog, g, o0, p0, c.N, c.Tout, xs, ws, acc);
  if (has_b) conv_accumulate_tc<TI>(c.b, wpb, c.cog, g, o0, p0, c.N, c.Tout, xs, ws, acc2);

  // acc[mi][ni][2h + j]: output channel wm*32 + mi*16 + lane/4 + 8h, position wn*32 + ni*8 + 2*(lane%4) + j
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int P = c.N * c.Tout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int p = p0 + wn * 32 + ni * 8 + 2 * (lane & 3) + j;
          if (p < P)
            conv_store(c, g, o0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * h, p, acc[mi][ni][2 * h + j],
                       acc2[mi][ni][2 * h + j]);
        }
}

template <typename TI>
cudaError_t pack(const Operand<bf16, TI>& a, int cog, int G, bf16* out, cudaStream_t stream) {
  const long long n = (long long)G * cog * a.cig * a.K;
  pack_kernel<TI><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(a, cog, n, out);
  ENC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

// Packs the weights of a (and b) into wpa (wpb), each enc::pack_elems(L) values,
// and launches the engine.
template <typename TI, typename TO>
cudaError_t launch_conv_tc(const ConvArgs<bf16, TI, TO>& c, int G, bf16* wpa, bf16* wpb, cudaStream_t stream) {
  ENC_CHECK(pack(c.a, c.cog, G, wpa, stream));
  if (c.b.x != nullptr) ENC_CHECK(pack(c.b, c.cog, G, wpb, stream));
  const Geometry ga(c.a.cig, c.a.K, c.a.stride, c.Tout), gb(c.b.cig, c.b.K, c.b.stride, c.Tout);
  const int bytes = conv_smem_bytes(ga, c.b.x != nullptr ? &gb : nullptr);
  auto kern = &conv_kernel_tc<TI, TO>;
  // every launch: a cache in a function-local static would be one object for
  // both libraries that include this header (the dynamic linker unifies it)
  ENC_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  const dim3 grid((unsigned)(((long long)c.N * c.Tout + BN - 1) / BN), G * c.cog / BM);
  kern<<<grid, THREADS, bytes, stream>>>(c, wpa, wpb);
  ENC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

// ------------------------------------------------------ weight-gradient engine
struct DwArgs {
  const float* dy;
  int dyC, dyT, dy_ts, dy_to;
  const bf16* x;
  int xC, xT, x_gs, x_off;
  int cig, K, pad;           // stride 1
  int N, Tout, cog;
  float* part;               // [range][G*cog][cig*K]
  int per;                   // positions per range, a multiple of BP
};

constexpr int DW_THREADS = 256;  // eight warps, 2 (output channels) x 4 (input channels), each 32 x 16 per tap

inline bool dw_ok(int cig, int cog, int K, int stride, int Tout) {
  return cig % BN == 0 && cog % BM == 0 && (K == 1 || K == 3 || K == 7) && stride == 1 && Tout % 16 == 0 &&
         (Tout % BP == 0 || BP % Tout == 0);
}

// dynamic shared memory: dy [BP/8][BM][8] and x [BN/8][rows][8], each
// twice; afterwards the same bytes hold the block's float sums [BM][BN*K]
inline int dw_smem_bytes(int K, int Tout) {
  const Geometry geo(BN, K, 1, Tout);
  const int pipeline = 2 * (BP / 8 * BM * 16 + geo.x_bytes()), sums = BM * BN * K * 4;
  return pipeline > sums ? pipeline : sums;
}

// grid: (cig/BN, G*cog/BM, ranges). A block takes a 64 x 64 tile of (o, i)
// for all K taps of one position range. Per chunk of BP positions it stages
// dy as [p/8][o][8] (the A operand, rows o) and x with the taps' halo as
// [i/8][row][8] (the B operand through ldmatrix.trans, rows = time), so a tap
// is a row offset and each x row is staged once for all taps; one A fragment
// serves the K taps' products.
template <int K>
__global__ void __launch_bounds__(DW_THREADS) dw_kernel_tc(const DwArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wi = warp & 3;
  const Geometry geo(BN, K, 1, a.Tout);
  const int plane_rows = geo.segs * geo.rows;
  const int x_items = geo.chunks * plane_rows;
  constexpr int DY_ITEMS = BP / 8 * BM / DW_THREADS;  // 2
  constexpr int X_MAX = 3;                            // ceil(max x_items / DW_THREADS): 8 * 72 rows
  uint4* dys[2] = {reinterpret_cast<uint4*>(smem), reinterpret_cast<uint4*>(smem) + BP / 8 * BM};
  uint4* xs[2] = {reinterpret_cast<uint4*>(smem) + 2 * BP / 8 * BM,
                  reinterpret_cast<uint4*>(smem) + 2 * BP / 8 * BM + x_items};
  const int i0 = blockIdx.x * BN;
  const int oc0 = blockIdx.y * BM;
  const int g = oc0 / a.cog, o0 = oc0 - g * a.cog;
  const int P = a.N * a.Tout;
  const int lo = blockIdx.z * a.per, hi = min(P, lo + a.per);

  // staging in registers: dy items (o = e % BM, 8 positions of chunk e / BM),
  // x items (channel chunk, row), loaded while the previous chunk's products run
  float dv[DY_ITEMS][8];
  bf16 xv[X_MAX][8];
  const bf16 zero = __float2bfloat16_rn(0.f);
  auto load = [&](int q0) {
#pragma unroll
    for (int q = 0; q < DY_ITEMS; ++q) {
      const int e = tid + q * DW_THREADS, o = e % BM, pc = e / BM;
      const int p = q0 + pc * 8;  // 8 positions of one sample
      const bool in = p < hi;
      const int n = in ? p / a.Tout : 0, t = in ? p - n * a.Tout : 0;
      const float* d = a.dy + ((long long)n * a.dyC + g * a.cog + o0 + o) * a.dyT + t * a.dy_ts + a.dy_to;
      if (in && a.dy_ts == 1) {
        const float4 u = *reinterpret_cast<const float4*>(d), v = *reinterpret_cast<const float4*>(d + 4);
        dv[q][0] = u.x, dv[q][1] = u.y, dv[q][2] = u.z, dv[q][3] = u.w;
        dv[q][4] = v.x, dv[q][5] = v.y, dv[q][6] = v.z, dv[q][7] = v.w;
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) dv[q][j] = in ? d[j * a.dy_ts] : 0.f;
      }
    }
#pragma unroll
    for (int q = 0; q < X_MAX; ++q) {
      const int e = tid + q * DW_THREADS;
      const int c = e / plane_rows, rr = e - c * plane_rows;
      const int s = rr / geo.rows, r = rr - s * geo.rows;
      const int ps = q0 + s * geo.steps;
      const int n = ps / a.Tout, ti = ps - n * a.Tout - a.pad + r;
      const bool in = e < x_items && n < a.N && ti >= 0 && ti < a.xT;
      const bf16* src = a.x + ((long long)n * a.xC + g * a.x_gs + a.x_off + i0 + c * 8) * a.xT + ti;
#pragma unroll
      for (int j = 0; j < 8; ++j) xv[q][j] = in ? src[(long long)j * a.xT] : zero;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < DY_ITEMS; ++q) dys[buf][tid + q * DW_THREADS] = pack8(dv[q]);
#pragma unroll
    for (int q = 0; q < X_MAX; ++q) {
      const int e = tid + q * DW_THREADS;
      if (e >= x_items) break;
      float f[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) f[j] = to_f(xv[q][j]);
      xs[buf][e] = pack8(f);
    }
  };

  float acc[K][2][2][4];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[k][mi][ni][r] = 0.f;

  // per lane: the A row (dy) and the B row (x, ldmatrix.trans: matrices
  // (p 0-7 | 8-15) x (channel chunk 2wi | 2wi + 1))
  const uint32_t a_lane = ((lane >> 4) * BM + wm * 32 + (lane & 15)) * 16;
  const uint32_t b_lane = ((2 * wi + (lane >> 4)) * plane_rows + ((lane >> 3) & 1) * 8 + (lane & 7)) * 16;

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
      const int s = kk * 16 / geo.steps, tl = kk * 16 - s * geo.steps;
      const uint32_t brow = bbase + (s * geo.rows + tl) * 16;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, brow + k * 16);
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

  // acc[k][mi][ni][2h + j]: output channel wm*32 + mi*16 + lane/4 + 8h, input
  // channel wi*16 + ni*8 + 2*(lane%4) + j. The tile's rows (i, k) are one
  // contiguous run of BN*K partials per output channel: gather them in
  // shared memory, then write whole rows.
  float* sums = reinterpret_cast<float*>(smem);
  constexpr int ROW = BN * K;
#pragma unroll
  for (int k = 0; k < K; ++k)
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
            sums[o * ROW + i * K + k] = acc[k][mi][ni][2 * h + j];
          }
  __syncthreads();
  const int R = a.cig * K;
  float* part = a.part + (long long)blockIdx.z * gridDim.y * BM * R + (long long)oc0 * R + i0 * K;
  for (int e = tid; e < BM * ROW; e += DW_THREADS) {
    const int o = e / ROW, r = e - o * ROW;
    part[(long long)o * R + r] = sums[e];
  }
}

template <int K>
cudaError_t launch_dw_k(const DwArgs& a, int G, int ranges, cudaStream_t stream) {
  const int bytes = dw_smem_bytes(K, a.Tout);
  auto kern = &dw_kernel_tc<K>;
  ENC_CHECK(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  kern<<<dim3(a.cig / BN, G * a.cog / BM, ranges), DW_THREADS, bytes, stream>>>(a);
  ENC_CHECK(cudaGetLastError());
  return cudaSuccess;
}

inline cudaError_t launch_dw_tc(const DwArgs& a, int G, int ranges, cudaStream_t stream) {
  if (a.K == 7) return launch_dw_k<7>(a, G, ranges, stream);
  if (a.K == 3) return launch_dw_k<3>(a, G, ranges, stream);
  return launch_dw_k<1>(a, G, ranges, stream);
}

}  // namespace tc
}  // namespace enc
